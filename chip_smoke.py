"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                          # every phase (needs one card)
    python3 chip_smoke.py --phases kernels         # build and check the kernels only
    python3 chip_smoke.py --phases kernels,long    # ... and the S1024 runs
    python3 chip_smoke.py --phases kernels,mwn     # ... and the ResNet-32 MWN runs
    python3 chip_smoke.py --phases kernels,compiled  # ... and compiled blocks (CUDA graphs)
    python3 chip_smoke.py --phases kernels,itd     # ... and ITD / reinforce on the MWN flagship
    python3 chip_smoke.py --phases kernels,checkpoint,remat  # ... checkpoints and remat
    python3 chip_smoke.py --phases kernels,nas     # ... DARTS search and its evaluation phase
    python3 chip_smoke.py --phases kernels,robust  # ... robust NAS and the 4-level SANAS
    python3 chip_smoke.py --phases kernels,programs  # ... IUC, learning by ignoring, iMAML
    python3 chip_smoke.py --phases kernels,pruning,ppo  # ... ImageNet data pruning, PPO
    python3 chip_smoke.py --phases kernels,moe,tutorials  # ... Switch MoE, the tutorials
    python3 chip_smoke.py --phases kernels,dist    # ... dp/zero/fsdp over torch.distributed
    python3 chip_smoke.py --phases kernels,mp      # ... tp/ep/pp/sp (two gloo ranks)
    python3 chip_smoke.py --mp-four                # four cards: mdl x pp, pp, sp, tp, ep

Phases:

1. set-up: print the card's name and power limit, turn TF32 off, build the
   CUDA sources of ``betty_tpu_torch/csrc`` (one ``nvcc`` each, all started
   together, each timed);
2. kernels (always): hold each single-tile flash-attention kernel (B1, B2)
   against its plain PyTorch version on the card at the SAMA path's shape
   (B32 H16 S128 D64) in bfloat16 and float32, with an all-true mask, a
   padded mask, a fully masked row and causal masking, and at four edge
   shapes (S16 D64, the small runs' ragged tile; S96 D16 padded; S200 D128
   with a fully masked row; S320 D32 causal), where ``flash_attention``
   with the default blocks must launch B1 and B2 and no multi-tile kernel;
   bf16 B1 is held elementwise to one bf16 ulp of its plain version (p
   rounded against the row max on both sides); time them (with their
   achieved TFLOP/s) beside their plain versions and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it), each as the mean of 20 launches queued back to back behind a
   sleeping kernel between one pair of events, so that the host's enqueue
   rate is not timed; the same for the multi-tile
   kernels (B3, B4, B5) at the long-sequence path's shape (B8 H16 S1024
   D64) and at four edge shapes (S384 with blocks of 128 and causal
   masking; S96 with blocks of 32 and D16, a ragged last tile; S256 D128
   with blocks of 128 and a fully masked row; S320 D32 with blocks of 64
   and causal masking), where ``flash_attention`` with those blocks must
   launch B3-B5 and not B1/B2 (every float32 kernel within 1e-5: o and lse
   absolutely, gradients relative to max|ref|); then blocks equal to the
   sequence past JAX's single-tile feasibility rule (S1024 and S1152 at
   D64 in bf16, S2048, S1024 in fp32), where each direction must launch
   what the rule (and bf16 B1's 1,024 keys) chooses;
   the multi-tile timings with their achieved TFLOP/s; each kernel's
   registers and spills as ``ptxas`` reports them (the bf16 tensor-core
   kernels and the float32 kernels, B1-B5 each, may not spill at D64),
   the count of tensor-core (``HMMA``) instructions in each tensor-core
   kernel at every head dim from ``cuobjdump --dump-sass`` (it must not be
   0), and the ``FFMA``, ``LDS`` and ``LDS.128`` counts of the float32
   B1-B5 and of each of their product loops (at D64 at least 8
   ``FFMA`` per shared-memory load in every product loop, and no
   ``HMMA``);
   then the solvers' vector kernels (B6, B7, B8) at the CG/Neumann path's
   length (the RoBERTa-large classifier's parameter count, padded to the
   ravel tile) and at a ragged length, timed beside their plain versions
   (no single PyTorch call computes any of the three);
3. slice: small fp32 reweighting runs (SAMA with ``--flash``, then CG and
   Neumann on the plain attention with the fused vector loops) on the card
   against the same runs on the CPU (plain versions) from the same weights;
   then data reweighting of the RoBERTa-large encoder (24 layers, d 1024, 16
   heads, random weights from a seed) at B32 S128 through ``build_engine``
   and ``Engine.run``: two SAMA meta-periods with ``--flash`` and one more
   under ``torch.profiler``; two CG meta-periods (3 iterations, fused
   vector loops, dropout 0.1) and one more under the profiler; two Neumann
   meta-periods (3 iterations);
4. long: the small fp32 SAMA ``--flash`` run at S1024 on the card against
   the CPU (the multi-tile path); then SAMA reweighting of the RoBERTa-large
   encoder at B8 S1024 with ``--flash``: two meta-periods and one more
   under the profiler (flash device time split by input dtype).
5. mwn: the Meta-Weight-Net flagship (``examples/learning_to_reweight.py``),
   which runs no kernel of the port (cuDNN convolutions and BatchNorm, as
   the JAX package's are XLA's): a small run (a 3-block ResNet, B8, 3 darts
   meta-periods, then 2 CG periods whose HVPs go forward-over-reverse
   through BatchNorm) on the card against the CPU from the same weights,
   in float64 within 1e-9 and in float32 at four weight seeds (reported:
   a ReLU input within rounding of 0 may take the other branch on one
   side); then the example's defaults (ResNet-32 at B128, MWN, darts,
   unroll 1, fp32, data on the device): 3 warm-up and 20 timed
   meta-periods (median and quartiles of s/meta-period, peak memory, no
   launch of the port's kernels) and one under the profiler (busy and
   idle share, device time by op class, launches); ``--baseline`` for 5
   steps; ``entry()`` on the card against the CPU within 1e-5.
6. compiled: compiled blocks (``betty_tpu_torch/compile.py``: one CUDA
   graph replay a meta-period) against driver mode on the card. Driver-mode
   Adam against optax's float32 arithmetic (bias corrections as 0-d device
   tensors: no element may differ; as Python numbers, reported). Small runs,
   compiled and twice in driver mode from the same weights, each with an
   LR schedule that changes within the run and one replay a period (3 or
   more): SAMA at S16 (dropout 0.1, Adam, B1/B2 in the graph), SAMA at
   S1024 (B3-B5), CG and Neumann with the fused vector loops (B6-B8), the
   3-block MWN in float64; compiled within the driver-vs-driver spread
   (bit for bit where it is 0), one capture and one replay a period, each
   kernel's launches recorded in the graph equal to driver mode's a
   period, fresh dropout seeds every replay. Then the MWN flagship
   (ResNet-32 B128, driver, compiled, compiled, driver; 3 + 10 timed
   periods and a profiled one each) and S128 SAMA ``--flash`` (driver,
   then compiled: a first period, 2 timed and a profiled one): period,
   device busy and idle share, launches, capture time, peak memory.
7. itd: iterative differentiation (``IterativeProblem`` under a
   ``first_order=False`` reweighter) and the ``reinforce`` solver on the MWN
   example, built from its engine's pieces (``mwn_variant``). Small float64
   runs (3-block ResNet, B8, cuDNN deterministic; ITD at unroll 1 and 3,
   reinforce) on the card against the CPU from the same weights within
   1e-9 (reinforce with host-drawn directions on both sides), and compiled
   against driver mode on the card bit for bit (reinforce with its own
   generator in the graph's pool: fresh directions every replay); an
   ``EngineConfig.profile_dir`` trace in both modes; then the flagship's
   defaults (ResNet-32 B128, fp32, a MultiStepLR at 10000/13000) as ITD at
   unroll 1 and 5 and as reinforce (4 samples), driver mode then compiled:
   2 + 3 timed periods and a profiled one each (period, busy, idle share,
   launches, peak memory, capture), the two modes' parameters, losses and
   norms, finite losses, no launch of the port's kernels.
8. checkpoint: engine checkpoints (``betty_tpu_torch/checkpoint.py``)
   resumed by a fresh engine through ``auto_resume``. Small float64 MWN
   runs (3-block ResNet, B8, cuDNN deterministic), darts under roll-back
   and ITD, both at unroll 3 with the cut mid-unroll (a live roll-back
   cache; one recorded ITD batch), in driver mode and compiled: the resumed
   state equals the uninterrupted run's bit for bit. The north star (S128
   SAMA ``--flash``, compiled): one period, a checkpoint at its block
   boundary, and a fresh engine resumed to two periods (a new capture),
   parameters bit for bit against two uninterrupted periods; the
   checkpoint's bytes, the seconds to save and to restore, the memory held
   and peak while saving. The MWN flagship (ResNet-32 B128, float32,
   compiled) with cuDNN deterministic, 16 periods uninterrupted against 8
   + 8 resumed, compared on fixed-batch losses (equal); beside it 16
   periods with cuDNN's default algorithms: what determinism costs the
   period and the device time.
9. remat: rematerialized encoder blocks (``models/transformer.py``). SAMA
   ``--flash`` at B8 S1024 in driver mode with remat off, "full" (the
   flash residuals kept) and "minimal" (everything replayed): 3 periods
   each (the first warm-up, the last profiled: the card's kernels), peak
   memory (inside the optimizer steps and elsewhere), the launches
   of B3-B5 a period held exactly (216, 144, 144 off and under "full";
   under "minimal" 360 B3, one replay a block backward), and the
   parameters against remat off; S128 SAMA ``--flash --remat`` in driver
   mode and compiled (B1/B2 a period as without remat, the parameters of
   the two modes); "dots" on the plain attention at S128, 2 periods and
   peak.

10. nas: DARTS architecture search (``examples/neural_architecture_search.py``)
   and its evaluation phase (``examples/nas_eval.py``), which launch no
   kernel of the port (cuDNN and PyTorch convolutions, pools, BatchNorm).
   Small float64 runs (cuDNN deterministic): the search at C4 L3 B8 for 3
   meta-periods under roll-back and the evaluation phase (DARTS_V2 C4 L4
   B8, auxiliary head, cutout, drop-path 0, 3 steps) on the card against
   the CPU from the same weights within 1e-9, and compiled against driver
   mode on the card bit for bit. Then the search at the published DARTS
   width (C16 L8 B64, float32, TF32 off; 1,401 leaves and 929 BatchNorms
   held), driver mode then compiled: 1 + 1 timed periods and a profiled
   one each (period, busy, idle, launches, device time by op class, peak
   memory, capture), fixed-batch losses of the first period within 1e-3
   between the modes, a genotype of 8 + 8 edges, 0 launches of B1-B8; and
   the evaluation phase at DARTS's CIFAR-10 settings (DARTS_V2 C36 L20
   B96, auxiliary 0.4, drop-path 0.2, cutout 16, grad clip 5) in both
   modes, 1 + 1 timed steps and a profiled one. Each of its lines carries
   the card's name and power limit.
11. robust: robust NAS (``examples/robust_nas.py``: the DARTS search whose
   classifier loss adds the input-Jacobian and CURE terms, second order
   through the inputs) and the 4-level saliency-aware NAS
   (``examples/saliency_aware_nas_4_level.py``: three problems, three
   hypergradient paths into the outer one, a PGD attack inside a step),
   which launch no kernel of the port. Small float64 runs (cuDNN
   deterministic): the robust search at C2 L1 B4 with both terms for 2
   meta-periods on the ``darts`` and the ``mlp`` backbone, and SANAS at dim
   16, 3 classes for 4 outer steps, on the card against the CPU from the
   same weights within 1e-9 (the Jacobian directions drawn on the host on
   both sides), and compiled against driver mode on the card bit for bit
   (the directions from the example's generator, reseeded every replay).
   Then the robust search at the DARTS search widths with the depth cut
   to 3 cells (C16 L3 B32, both terms, float32, TF32 off; 550 leaves and
   359 BatchNorms held), driver mode then compiled: 2 + 2 timed
   periods and a profiled one each (period, busy, idle, launches, device
   time by op class and convolution time by kernel, peak memory, capture
   split into warm-up and recording), the fixed-batch losses of the first
   periods within 1e-3 between the modes, and one more driver period that
   counts its convolutions at the dispatcher (none may be a per-group one
   of PyTorch's conv double backward); then SANAS at the JAX example's
   defaults in driver mode for 20 outer periods (finite losses, three
   paths, counts 8:4:2 per 8 inner1 steps). B1-B8 launch 0 times in every run. Each of
   its lines carries the card's name and power limit.
12. programs: the 3-level image-captioning NAS
   (``examples/nas_augmented_image_captioning_3_level.py``: a causal
   transformer decoder with cross-attention, greedy decoding inside a
   step), learning by ignoring (``examples/learning_by_ignoring.py``:
   per-group learning rates through ``param_groups``) and implicit MAML
   (``examples/implicit_maml.py``: an env-fed program on the Omniglot CNN,
   CG with gradient accumulation), which launch no kernel of the port.
   Small float64 runs (cuDNN deterministic) of each on the card against the
   CPU from the same weights within 1e-9 relative, IUC and LBI compiled
   against driver mode on the card bit for bit; one LBI step on the card
   whose two groups moved by their own rates; then each at its JAX
   example's defaults (LBI with features_lr 0.08 and classifier_lr 0.02):
   IUC (n 512, B32, seq_len 12, d 64, depth 2, 4 heads, unroll 2 and 2)
   and LBI in driver mode then compiled, iMAML (5-way 1-shot, 5 inner
   steps, meta batch 4) in driver mode: 3 + 8, 3 + 20 and 3 + 5 timed
   periods (an IUC outer period is 4 inner1 steps, an iMAML meta update 20
   inner steps) and a profiled one each (period, busy, idle, launches,
   peak, capture), counts a period and paths, the fixed-batch losses of the
   two modes within 1e-3. B1-B8 launch 0 times. Each of its lines carries
   the card's name and power limit.
13. pruning: ImageNet data pruning (``examples/imagenet_pruning.py``: a
   bottleneck ResNet student with an EMA teacher in its state under a
   two-feature Meta-Weight-Net, darts, device augmentation), which launches
   no kernel of the port. Small float64 runs (cuDNN deterministic; B4,
   32x32, stages [1, 1], width 8, ``--gas 2``, 4 meta-periods; and with
   ``--augment device`` at 40 -> 32) on the card against the CPU from the
   same weights within 1e-9 relative (crop draws made on the host on both
   sides), compiled against driver mode on the card bit for bit (the
   example's own draws), the EMA teacher moved in every run;
   ``WideResNet(10, 2)`` in float64, logits and one SGD step, card against
   CPU within 1e-9. Then ResNet-50 at the JAX example's defaults (B32,
   224x224, 1,000 classes, ``--gas 1``, TF32 off, ``--device_data``): fp32
   in driver mode and compiled, ``--augment device`` (crops 224) and
   ``--precision bf16`` compiled; 3 + 5 timed periods and a profiled one
   each (period, busy, idle, launches, device time by op class, peak,
   capture and its warm-up part), counts 1:1 a period and one path into the
   reweighter, the batch statistics float32, the fixed-batch losses after
   the first periods (driver against compiled within 1e-3; the augmented
   and bf16 runs' beside fp32's), and the transforms' share of device time
   (a period's transforms profiled alone).
14. ppo: PPO (``examples/ppo.py``: a numpy CartPole on the host, a rollout
   env that reads the actor's and the critic's outputs back every step),
   which launches no kernel of the port. A small float64 run (4 envs,
   horizon 32, 8 iterations) on the card against the CPU within 1e-9
   relative with equal actions; then the JAX example's defaults (8 envs,
   horizon 128, 200 iterations, a rollout every 8) in driver mode: seconds
   an iteration and a rollout, a rollout's launches and host reads, a
   profiled rollout block's busy and idle, peak memory, counts 200:200,
   ``mean_return``. B1-B8 launch 0 times in both phases.
15. moe: the Switch top-1 MoE feed-forward layer (``models/moe.py``: dense
   one-hot dispatch and combine einsums) in the one-device bilevel program
   of the JAX package's ``tests/test_ep.py`` (``examples/moe_reweighting.py``:
   the layer with a residual and a linear head under a Meta-Weight-Net,
   darts, unroll 2), which launches no kernel of the port. ``moe_ffn`` at
   DIM 16 / HID 32 / E 4 / T 64 in float64 for capacities T, 2 and the
   default, forward, ``aux`` and every gradient, and the program at those
   widths (every token to its expert, 4 iterations), on the card against
   the CPU from the same weights within 1e-12 relative, compiled against
   driver mode bit for bit. Then the program at the published
   Switch-Base-8's widths (d_model 768, d_ff 3072, 8 experts, capacity
   factor 1.25: 640 slots an expert; 4,096 tokens a step), float32, TF32
   off, driver mode then compiled: 3 + 8 timed periods and a profiled one
   each (period, busy, idle, launches, peak, capture), a driver period's
   device time split by the matmul that launched each kernel (the dispatch
   and combine einsums, the expert products, the rest), the fixed-batch
   losses of the two modes within 1e-3; then ``--precision bf16``
   compiled, and one period's routing in bf16: more than 256 tokens to one
   expert, each expert's kept positions 0..min(n_e, C) - 1 used once.
16. tutorials: ``test_install.main()`` at its defaults (its Hello line,
   loss, seconds); tutorials 1 (and ``--baseline``), 2, 3, 4 and 8 at
   ``TUTORIAL_ITERS`` in driver mode (seconds, the fixed-batch losses,
   2's test accuracy, 3's sink and, with TensorBoard, its scalar events
   read back, 8's printed norm); tutorial 6's four configurations'
   meta-steps/s; ``prefetch_to_device`` on the card (batches equal to the
   host's, in order). B1-B8 launch 0 times in both phases.
17. dist: the data-parallel strategies over ``torch.distributed``, each
   leg in subprocesses of this script (``--dist-worker``) with a timeout;
   any rank's failure or timeout fails the phase. A world of one over NCCL
   (the collectives made over one rank): the north star (the ``slice``
   argv: RoBERTa-large S128 B32, SAMA, bf16, ``--flash``) for 2
   meta-periods under ``--strategy default`` and under ``--strategy
   fsdp`` at the same seed, parameters and every step's loss equal bit for
   bit, B1/B2 at 432/288 in both, each period, the peak memory, and one
   profiled period of each with the collective calls and the NCCL kernels
   (at one rank NCCL runs them as device copies) with their device time;
   then the north star under tp at ``dp:1,mdl:1`` against that `default`
   run, the MoE at Switch-Base-8's widths under ``ep:1`` and compiled tp
   (the mp checks of a world of one, phase 18); then tutorial 7's program
   on ``make_pipelined_transformer`` at RoBERTa-large's widths (fp32, B32
   S128, darts, ``PP_PERIODS`` meta-periods and a profiled one) under
   ``default``, ``pp:1`` (GPipe, M 4) and ``sp:1`` from one start, the
   parameters' distance from default's within ``PP_NORTH_REL_TOL`` of how
   far they moved and the losses within ``PP_NORTH_LOSS_TOL``, each with its
   period, peak, ring-shift and gather calls and collective device time,
   and compiled ``pp:1`` and ``sp:1`` at small width against driver, bit
   for bit; the composed mesh at a world of one (``dp:1,mdl:1,pp:1``,
   tutorial 7's pp mode with ``models.COMPOSED_SHARD_RULES``) small in
   float64 against ``default`` (1e-10) and compiled against driver, bit
   for bit; then the small reweighting
   run under dp and zero against default, and compiled fsdp against
   driver, bit for bit. Before it, two ranks on the one card
   over gloo with CUDA tensors (NCCL takes one rank a device): tutorial 5's
   program in float64 under dp, zero and fsdp, held to this process's
   one-process run on the global batch (1e-10) and zero/fsdp to dp bit for
   bit.
18. mp: tensor and expert parallelism. Two gloo ranks on the card with
   CUDA tensors: the small transformer under tp at ``mdl:2`` with the fp32
   flash kernels (losses within 1e-5 relative; the parameters' distance
   from one process's within ``MP_FLASH_REL_TOL`` of how far they moved)
   and in float64 (1e-10), the test's MoE under ep at ``ep:2`` in float64
   (1e-10), each against this process's one-process run. The world of one
   over NCCL runs in the dist phase's (phase 17), after its `default` north
   star: the north star under tp at ``dp:1,mdl:1`` against `default` (the
   parameters' distance within ``MP_NORTH_REL_TOL`` of how far they moved,
   the 12 losses within 5e-2: the row-parallel biases are added after the
   sum, in bf16), B1/B2 432/288, a profiled period with the collective
   calls; the host cost of one row-parallel sum; the MoE at Switch-Base-8's
   widths under ``ep:1`` against default (``MP_MOE_TOL``); compiled tp at
   small width against driver, bit for bit.
   The two gloo ranks also run tutorial 7's program small in float64
   under pp (``pp:2``, M 2) and sp (``sp:2``), darts and CG, against one
   process (1e-10); beside them four gloo ranks on the card run it on the
   composed mesh ``mdl:2,pp:2`` (M 2), darts and CG, against the same
   one-process runs (1e-10).
   ``--mp-four`` (four cards, NCCL, one rank a card) runs tutorial 7's
   program at RoBERTa-large's widths on the composed mesh ``mdl:2,pp:2``
   (M 4; ``composed_four``: rank 0 first runs one card's ``default`` from
   the same start, and the composed run is held to it on ``|run - default|
   / |default - start|`` within ``COMPOSED_NORTH_REL_TOL`` and the losses
   within ``COMPOSED_NORTH_LOSS_TOL``), under ``pp:4`` (M 4 and 8) and
   ``sp:4`` (``pp_four``), then the MoE under ``ep:4`` against one process
   and the north star under tp at ``mdl:4`` and ``dp:2,mdl:2``: periods,
   busy, idle, launches, peak a card, the collective calls by group and
   the NCCL kernels by kind of a profiled period.

Each run reads the launch counts of its kernels, set to 0 just before it,
and holds them to the counts its code path implies.

Prints one JSON line of kernel results, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when there is no CUDA card, when the port cannot be imported, or
when any phase fails.
"""

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its operand type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SHAPE = dict(B=32, H=16, S=128, D=64)  # the single-tile path (S128 SAMA run)
LONG_SHAPE = dict(B=8, H=16, S=1024, D=64)  # the multi-tile path (S1024 SAMA run)
# multi-tile edge shapes: (B, H, S, D, block, mask case)
EDGE_SHAPES = [(2, 4, 384, 64, 128, "causal"), (2, 4, 96, 16, 32, "padded"),
               (2, 4, 256, 128, 128, "masked_row"), (2, 4, 320, 32, 64, "causal")]
# single-tile edge shapes (default blocks): (B, H, S, D, mask case)
SINGLE_EDGE_SHAPES = [(2, 4, 16, 64, "all_true"), (2, 4, 96, 16, "padded"),
                      (2, 4, 200, 128, "masked_row"), (2, 4, 320, 32, "causal")]
KERNEL_TILE = 64  # rows per tile of the CUDA flash kernels
# JAX's single-tile feasibility rule at blocks equal to the sequence: (B, H,
# S, D, dtype name, kernels flash_attention launches). At D64 the bf16
# forward takes one tile up to 1,191 keys (bf16 B1 up to 1,024: past it the
# card takes B3) and the backward up to 825; fp32 forward up to 1,132
FEASIBILITY_SHAPES = [
    (1, 4, 1024, 64, "bfloat16", ("flash_single_fwd", "flash_multi_bwd_dkv",
                                  "flash_multi_bwd_dq")),
    (1, 4, 1152, 64, "bfloat16", ("flash_multi_fwd", "flash_multi_bwd_dkv",
                                  "flash_multi_bwd_dq")),
    (1, 4, 2048, 64, "bfloat16", ("flash_multi_fwd", "flash_multi_bwd_dkv",
                                  "flash_multi_bwd_dq")),
    (1, 4, 1024, 64, "float32", ("flash_single_fwd", "flash_multi_bwd_dkv",
                                 "flash_multi_bwd_dq")),
]


def roberta_large_params(vocab=50265, max_len=128, d=1024, depth=24, classes=2):
    """Parameter count of the port's RoBERTa-large classifier by its shapes:
    embeddings (``max_len`` position rows: the example sets it to the
    sequence length), 24 blocks of 12 d^2 + 13 d (q/k/v/out projections with
    biases, two LayerNorms, the 4d MLP), the final LayerNorm, pooler and
    head."""
    return (vocab * d + max_len * d + depth * (12 * d * d + 13 * d) + 2 * d + d * d + d
            + d * classes + classes)


RAVEL_TILE = 8 * 1024
N_PARAMS = roberta_large_params()  # at S128, the CG/Neumann path
N_VECTOR = -(-N_PARAMS // RAVEL_TILE) * RAVEL_TILE  # the CG/Neumann path's vector length
N_RAGGED = 3 * RAVEL_TILE + 1000
TOL = {  # (forward, backward relative to max|reference|)
    # float32: exact FMAs on the CUDA cores, only the order of sums differs
    "float32": (1e-5, 1e-5),
    "bfloat16": (1e-2, 2e-2),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


SLEEP_CYCLES = 50_000_000  # about 25 ms of the card's clock: longer than 20 calls' host work


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of one call of ``fn``: ``reps`` calls after
    ``warmup`` ones, between one pair of events, queued behind a kernel that
    sleeps while the host enqueues them, so that they run back to back on
    the device and the host's enqueue rate is not what is timed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _free():
    """Return the memory of dropped objects to the card: ``Engine`` and each
    ``Problem`` refer to each other, so they are freed by the cyclic
    collector only, and ``empty_cache`` alone keeps their blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _inputs(dtype, case, gen, shape=SHAPE):
    import torch

    B, H, S, D = shape["B"], shape["H"], shape["S"], shape["D"]
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    if case == "padded":
        lengths = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
        mask = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
    elif case == "masked_row":
        mask[0, S // 2:] = False
        mask[1, :] = False
    return q, k, v, do, mask, case == "causal"


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (8 significant bits): 2^(e-8)
    for |x| = m 2^e with 0.5 <= m < 1, and at most the smallest normal's."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _single_check(dtype, shape, case, gen, worst):
    """B1 and B2 against their plain versions on one input; B2 is compared
    on the kernel's own o and lse. In bf16, B1's o is held elementwise to
    one bf16 ulp of the plain o: both round p against the row max, so only
    the order of float32 sums differs. Returns True if all agree."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    dname = str(dtype).split(".")[-1]
    tf, tb = TOL[dname]
    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    sm = 1.0 / math.sqrt(shape["D"])
    o, lse = fa._fwd_single(q, k, v, mask, causal=causal, sm_scale=sm)
    po, plse = fa._fwd_single_plain(q, k, v, mask, causal=causal, sm_scale=sm)
    torch.cuda.synchronize()
    scale_o = max(1.0, float(po.float().abs().max())) if dname == "bfloat16" else 1.0
    e_o, e_lse = _err(o, po), _err(lse, plse)
    ok_f = e_o <= tf * scale_o and e_lse <= tf * max(1.0, float(plse.abs().max()))
    ulp_note = ""
    if dname == "bfloat16":
        diff = (o.float() - po.float()).abs()
        in_ulps = diff / bf16_ulp(po)
        over = int((in_ulps > 1.0).sum())
        ok_f &= over == 0
        ulp_note = (f" share of o differing {float((diff > 0).float().mean()):.3e}, max "
                    f"{float(in_ulps.max()):.2f} bf16 ulp, {over} elements over 1 ulp;")
    if case == "masked_row":
        ok_f &= bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    dq, dk, dv = fa._bwd_single(q, k, v, do, o, lse, mask, causal=causal, sm_scale=sm)
    pq, pk, pv = fa._bwd_single_plain(q, k, v, do, o, lse, mask, causal=causal, sm_scale=sm)
    torch.cuda.synchronize()
    pairs = ((dq, pq), (dk, pk), (dv, pv))
    e_b = max(_err(a, b) / max(float(b.float().abs().max()), 1e-30) for a, b in pairs)
    ok_b = e_b <= tb and all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    worst["flash_single_fwd"] = max(worst["flash_single_fwd"], e_o)
    worst["flash_single_bwd"] = max(worst["flash_single_bwd"], *(_err(a, b) for a, b in pairs))
    geo = "B{B} H{H} S{S} D{D}".format(**shape)
    log(f"[kernels] B1/B2 {geo} {dname:8s} {case:10s} fwd |o|err {e_o:.3e} |lse|err "
        f"{e_lse:.3e} (tol {tf:g}{' x max|o|' if scale_o != 1.0 else ''});{ulp_note} "
        f"bwd rel err {e_b:.3e} (tol {tb:g}) -> {'ok' if ok_f and ok_b else 'FAIL'}")
    return ok_f and ok_b


def _dispatch_check(dtype, shape, case, gen, block, want_kernels):
    """``flash_attention`` forward and backward with ``block`` (None: the
    default) launches each kernel of ``want_kernels`` once and no other,
    and gives finite gradients. Returns a failure string or None."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    qg, kg, vg = (t.requires_grad_(True) for t in (q, k, v))
    fa.reset_launch_counts()
    out = fa.flash_attention(qg, kg, vg, mask, causal=causal, block_q=block, block_kv=block)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    counts = {name: f.launches for name, f in fa.KERNELS.items()}
    want = {name: int(name in want_kernels) for name in fa.KERNELS}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    dname = str(dtype).split(".")[-1]
    log(f"[kernels] flash_attention S{shape['S']} D{shape['D']} {dname} blocks "
        f"{block or 'default'}: launches {counts}; finite gradients {finite}")
    fa.reset_launch_counts()
    if counts != want or not finite:
        return f"S{shape['S']}/{dname}/dispatch {counts} finite {finite}"
    return None


def kernel_phase():
    """B1/B2 at the S128 path's shape for both dtypes and the four mask
    cases, then at the single-tile edge shapes, where ``flash_attention``
    with the default blocks must launch B1 and B2 and nothing else. Returns
    the largest absolute error of each kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"flash_single_fwd": 0.0, "flash_single_bwd": 0.0}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in MASK_CASES:
            if not _single_check(dtype, SHAPE, case, gen, worst):
                failures.append(f"S{SHAPE['S']}/{dtype}/{case}")
    for B, H, S, D, case in SINGLE_EDGE_SHAPES:
        shape = dict(B=B, H=H, S=S, D=D)
        for dtype in (torch.bfloat16, torch.float32):
            if not _single_check(dtype, shape, case, gen, worst):
                failures.append(f"S{S}/{dtype}/{case}")
            bad = _dispatch_check(dtype, shape, case, gen, None, SINGLE_KERNELS)
            if bad:
                failures.append(bad)
    _free()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return worst


def kernel_timings():
    """Times at the main path's inputs: all-true kv mask, not causal."""
    import torch
    import torch.nn.functional as F
    from betty_tpu_torch.ops import flash_attention as fa

    B, H, S, D = SHAPE["B"], SHAPE["H"], SHAPE["S"], SHAPE["D"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    sm = 1.0 / math.sqrt(D)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do, mask, _ = _inputs(dtype, "all_true", gen)
        o, lse = fa._fwd_single(q, k, v, mask, causal=False, sm_scale=sm)
        attn_mask = mask[:, None, None, :]
        t_fwd = time_ms(lambda: fa._fwd_single(q, k, v, mask, causal=False, sm_scale=sm))
        p_fwd = time_ms(lambda: fa._fwd_single_plain(q, k, v, mask, causal=False, sm_scale=sm))
        l_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
        t_bwd = time_ms(lambda: fa._bwd_single(q, k, v, do, o, lse, mask, causal=False,
                                               sm_scale=sm))
        p_bwd = time_ms(lambda: fa._bwd_single_plain(q, k, v, do, o, lse, mask, causal=False,
                                                     sm_scale=sm))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask)
        l_bwd = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))

        n = B * H * S * D
        item = q.element_size()
        mm = 2 * B * H * S * S * D  # flops of one (S x S x D) product per head
        fwd_bytes = 3 * n * item + mask.numel() + n * item + B * H * S * 4
        bwd_bytes = 5 * n * item + B * H * S * 4 + mask.numel() + 3 * n * item
        for name, t, p, lib, nbytes, flops in (
                ("flash_single_fwd", t_fwd, p_fwd, l_fwd, fwd_bytes, 2 * mm),
                ("flash_single_bwd", t_bwd, p_bwd, l_bwd, bwd_bytes, 5 * mm)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rows[(name, dname)] = dict(
                ms=t, plain_ms=p, library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"[timing] {name} {dname:8s} kernel {t:.4f} ms ({flops / t * 1e-9:.1f} "
                f"TFLOP/s)  plain {p:.4f} ms  "
                f"sdpa {'backward ' if name != 'flash_single_fwd' else ''}{lib:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return rows


MULTI_KERNELS = ("flash_multi_fwd", "flash_multi_bwd_dkv", "flash_multi_bwd_dq")
SINGLE_KERNELS = ("flash_single_fwd", "flash_single_bwd")
MASK_CASES = ("all_true", "padded", "masked_row", "causal")


def _multi_check(dtype, shape, case, gen, worst):
    """B3, B4 and B5 against their plain versions on one input. The plain
    forward runs at the kernel's own 64-row tiles, so p is rounded against
    the same running max; B4 and B5 are compared on the kernel's own o and
    lse, with di = rowsum(o * do) in float32 as the backward computes it.
    Tolerances as B1/B2's (``TOL``). Returns True if all agree."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    dname = str(dtype).split(".")[-1]
    tf, tb = TOL[dname]
    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(shape["D"]))
    tiles = dict(block_q=KERNEL_TILE, block_kv=KERNEL_TILE)
    o, lse = fa._fwd_multi(q, k, v, mask, **tiles, **kw)
    po, plse = fa._fwd_multi_plain(q, k, v, mask, **tiles, **kw)
    torch.cuda.synchronize()
    scale_o = max(1.0, float(po.float().abs().max())) if dname == "bfloat16" else 1.0
    e_o, e_lse = _err(o, po), _err(lse, plse)
    ok_f = e_o <= tf * scale_o and e_lse <= tf * max(1.0, float(plse.abs().max()))
    if case == "masked_row":
        ok_f &= bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fa._bwd_dkv(q, k, v, do, lse, di, mask, **kw)
    dq = fa._bwd_dq(q, k, v, do, lse, di, mask, **kw)
    pk, pv = fa._bwd_dkv_plain(q, k, v, do, lse, di, mask, **kw)
    pq = fa._bwd_dq_plain(q, k, v, do, lse, di, mask, **kw)
    torch.cuda.synchronize()

    def rel(a, b):
        return _err(a, b) / max(float(b.float().abs().max()), 1e-30)

    e_dkv, e_dq = max(rel(dk, pk), rel(dv, pv)), rel(dq, pq)
    ok_b = (e_dkv <= tb and e_dq <= tb
            and all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv)))
    worst["flash_multi_fwd"] = max(worst["flash_multi_fwd"], e_o)
    worst["flash_multi_bwd_dkv"] = max(worst["flash_multi_bwd_dkv"], _err(dk, pk), _err(dv, pv))
    worst["flash_multi_bwd_dq"] = max(worst["flash_multi_bwd_dq"], _err(dq, pq))
    geo = "B{B} H{H} S{S} D{D}".format(**shape)
    log(f"[kernels] B3-B5 {geo} {dname:8s} {case:10s} fwd |o|err {e_o:.3e} |lse|err "
        f"{e_lse:.3e} (tol {tf:g}{' x max|o|' if scale_o != 1.0 else ''}) bwd rel err dk/dv "
        f"{e_dkv:.3e} dq {e_dq:.3e} (tol {tb:g}) -> {'ok' if ok_f and ok_b else 'FAIL'}")
    return ok_f and ok_b


def multi_kernel_phase():
    """B3-B5 at the long-sequence path's shape for both dtypes and the four
    mask cases, then at the edge shapes; there ``flash_attention`` with the
    edge's blocks must launch B3, B4 and B5 once each and neither B1 nor B2.
    Then blocks equal to sequences past JAX's single-tile feasibility rule
    (``FEASIBILITY_SHAPES``): each direction launches what the rule and
    bf16 B1's key limit choose. Returns the largest absolute error of each
    kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = dict.fromkeys(MULTI_KERNELS, 0.0)
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in MASK_CASES:
            if not _multi_check(dtype, LONG_SHAPE, case, gen, worst):
                failures.append(f"S{LONG_SHAPE['S']}/{dtype}/{case}")
    for B, H, S, D, block, case in EDGE_SHAPES:
        shape = dict(B=B, H=H, S=S, D=D)
        for dtype in (torch.bfloat16, torch.float32):
            if not _multi_check(dtype, shape, case, gen, worst):
                failures.append(f"S{S}/{dtype}/{case}")
            bad = _dispatch_check(dtype, shape, case, gen, block, MULTI_KERNELS)
            if bad:
                failures.append(bad)
    for B, H, S, D, dname, want in FEASIBILITY_SHAPES:
        bad = _dispatch_check(getattr(torch, dname), dict(B=B, H=H, S=S, D=D), "padded", gen, S,
                              want)
        if bad:
            failures.append(bad)
    _free()
    if failures:
        raise AssertionError(f"multi-tile kernels disagree with their plain versions: {failures}")
    return worst


def multi_kernel_timings():
    """B3-B5 at the long-sequence path's inputs (B8 H16 S1024 D64, all-true
    kv mask, not causal), beside their plain versions at the path's blocks
    (JAX's default 512) and PyTorch's ``scaled_dot_product_attention``: its
    forward for B3, its backward (which computes dq, dk and dv, the outputs
    of B4 and B5 together) for both B4 and B5."""
    import torch
    import torch.nn.functional as F
    from betty_tpu_torch.ops import flash_attention as fa

    B, H, S, D = (LONG_SHAPE[x] for x in "BHSD")
    gen = torch.Generator(device="cuda").manual_seed(4)
    kw = dict(causal=False, sm_scale=1.0 / math.sqrt(D))
    blocks = dict(block_q=fa.DEFAULT_BLOCK, block_kv=fa.DEFAULT_BLOCK)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do, mask, _ = _inputs(dtype, "all_true", gen, LONG_SHAPE)
        o, lse = fa._fwd_multi(q, k, v, mask, **blocks, **kw)
        di = (o.float() * do.float()).sum(-1)
        attn_mask = mask[:, None, None, :]
        bwd_args = (q, k, v, do, lse, di, mask)
        t_fwd = time_ms(lambda: fa._fwd_multi(q, k, v, mask, **blocks, **kw))
        p_fwd = time_ms(lambda: fa._fwd_multi_plain(q, k, v, mask, **blocks, **kw))
        l_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
        t_dkv = time_ms(lambda: fa._bwd_dkv(*bwd_args, **kw))
        p_dkv = time_ms(lambda: fa._bwd_dkv_plain(*bwd_args, **kw))
        t_dq = time_ms(lambda: fa._bwd_dq(*bwd_args, **kw))
        p_dq = time_ms(lambda: fa._bwd_dq_plain(*bwd_args, **kw))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask)
        l_bwd = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))

        n = B * H * S * D
        item = q.element_size()
        mm = 2 * B * H * S * S * D  # flops of one (S x S x D) product per head
        stats = B * H * S * 4  # one float32 value per row: lse or di
        for name, t, p, lib, nbytes, flops in (
                ("flash_multi_fwd", t_fwd, p_fwd, l_fwd,
                 3 * n * item + mask.numel() + n * item + stats, 2 * mm),
                ("flash_multi_bwd_dkv", t_dkv, p_dkv, l_bwd,
                 4 * n * item + 2 * stats + mask.numel() + 2 * n * item, 4 * mm),
                ("flash_multi_bwd_dq", t_dq, p_dq, l_bwd,
                 4 * n * item + 2 * stats + mask.numel() + n * item, 3 * mm)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rows[(name, dname)] = dict(
                ms=t, plain_ms=p, library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"[timing] {name} {dname:8s} kernel {t:.4f} ms ({flops / t * 1e-9:.1f} "
                f"TFLOP/s)  plain {p:.4f} ms  "
                f"sdpa {'backward ' if name != 'flash_multi_fwd' else ''}{lib:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        t_bwd = t_dkv + t_dq
        log(f"[timing] flash_multi_bwd_dkv + flash_multi_bwd_dq {dname:8s} {t_bwd:.4f} ms "
            f"({7 * mm / t_bwd * 1e-9:.1f} TFLOP/s) against sdpa backward {l_bwd:.4f} ms")
        del q, k, v, do, o, lse, di, ql, kl, vl, ol, bwd_args
        _free()
    return rows


VECTOR_KERNELS = ("fused_dot2", "cg_fused_step", "neumann_fused_step")


def vector_phase():
    """B6-B8 against their plain versions at the path's length and at a
    ragged one. Elementwise outputs agree within 1e-6 x max|ref| (the kernels
    contract a*b+c into one fused multiply-add, the plain versions round the
    product first); dots within 1e-5 x sum|a_i b_i| (the kernels sum in
    another order). Times at the path's length, as ``time_ms``."""
    import torch
    from betty_tpu_torch.ops import vector as vec

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {name: {"max_abs_err": 0.0} for name in VECTOR_KERNELS}
    failures = []

    def elementwise(name, got, want, n):
        err = _err(got, want)
        tol = 1e-6 * float(want.abs().max())
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        log(f"[vector] n={n} {name:18s} elementwise |err| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            failures.append(f"{name}/{n}")

    def dot(name, got, want, x, y, n):
        err = abs(float(got) - float(want))
        tol = 1e-5 * float((x * y).abs().sum())
        key = "max_abs_err" if name == "fused_dot2" else "dot_abs_err"
        rows[name][key] = max(rows[name].get(key, 0.0), err)
        log(f"[vector] n={n} {name:18s} dot {float(got):.6e} vs {float(want):.6e} "
            f"|err| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            failures.append(f"{name}/{n}/dot")

    for n in (N_VECTOR, N_RAGGED):
        a, b, c, d = (torch.randn(n, generator=gen, device="cuda") for _ in range(4))
        ak = torch.rand((), generator=gen, device="cuda")
        alpha = 0.5
        for got, want, (x, y) in zip(vec.fused_dot2(a, b, c, d), vec.fused_dot2_plain(a, b, c, d),
                                     ((a, b), (c, d))):
            dot("fused_dot2", got, want, x, y, n)
        x2, r2, rr = vec.cg_fused_step(ak, a, b, c, d)
        px, pr, prr = vec.cg_fused_step_plain(ak, a, b, c, d)
        elementwise("cg_fused_step", x2, px, n)
        elementwise("cg_fused_step", r2, pr, n)
        dot("cg_fused_step", rr, prr, pr, pr, n)
        for got, want in zip(vec.neumann_fused_step(alpha, a, b, c),
                             vec.neumann_fused_step_plain(alpha, a, b, c)):
            elementwise("neumann_fused_step", got, want, n)
        torch.cuda.synchronize()
        if n == N_VECTOR:
            calls = {
                "fused_dot2": (lambda: vec.fused_dot2(a, b, c, d),
                               lambda: vec.fused_dot2_plain(a, b, c, d), 16 * n, 4 * n),
                "cg_fused_step": (lambda: vec.cg_fused_step(ak, a, b, c, d),
                                  lambda: vec.cg_fused_step_plain(ak, a, b, c, d),
                                  24 * n + 8, 6 * n),
                "neumann_fused_step": (lambda: vec.neumann_fused_step(alpha, a, b, c),
                                       lambda: vec.neumann_fused_step_plain(alpha, a, b, c),
                                       20 * n, 3 * n),
            }
            for name, (kernel, plain, nbytes, flops) in calls.items():
                t, pt = time_ms(kernel), time_ms(plain)
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS["float32"] * 1e3
                rows[name].update(ms=t, plain_ms=pt, library_ms=None,
                                  bound_ms=max(t_bytes, t_ops),
                                  bound_by="bytes" if t_bytes >= t_ops else "operations")
                log(f"[timing] {name} n={n} kernel {t:.4f} ms  plain {pt:.4f} ms  "
                    f"bound {max(t_bytes, t_ops):.4f} ms "
                    f"({'bytes' if t_bytes >= t_ops else 'operations'}); library: none "
                    "(no single PyTorch call computes it)")
        del a, b, c, d, x2, r2, px, pr
        _free()
    if failures:
        raise AssertionError(f"vector kernels disagree with their plain versions: {failures}")
    return rows


SMALL_ARGV = ["--dim", "64", "--depth", "2", "--heads", "4", "--seq_len", "16",
              "--batch_size", "4", "--train_size", "64", "--meta_size", "32",
              "--precision", "fp32", "--dropout", "0", "--unroll_steps", "2", "--train_iters",
              "4"]
SOLVER_CONFIG = {  # the fused loops at the iterations of the logistic-HPO example
    "sama": {},
    "cg": dict(use_fused_vector_ops=True, cg_iterations=3),
    "neumann": dict(use_fused_vector_ops=True, neumann_iterations=3),
}


def _counters(hypergradient):
    """``(reset, counters)``: a function that sets every kernel's launch
    count to 0, and the counters of the kernels that a solver's path runs."""
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    def reset():
        fa.reset_launch_counts()
        vec.reset_launch_counts()

    if hypergradient == "sama":
        return reset, dict(fa.KERNELS)
    if hypergradient == "cg":
        return reset, {"fused_dot2": vec.fused_dot2, "cg_fused_step": vec.cg_fused_step}
    return reset, {"neumann_fused_step": vec.neumann_fused_step}


def _used(hypergradient, seq_len, counters):
    """The kernels of ``counters`` that a run's path launches: SAMA's flash
    attention is single-tile up to the default block (512), multi-tile
    beyond; the vector kernels are all on their solver's path."""
    if hypergradient != "sama":
        return set(counters)
    return set(SINGLE_KERNELS if seq_len <= 512 else MULTI_KERNELS)


def small_run_phase(hypergradient, seq_len=16, batch=4):
    """The small fp32 reweighting run on the card (kernels) and on the CPU
    (their plain versions) from the same weights: parameters agree within
    1e-4 after 4 classifier and 2 reweight steps, as the CPU tests hold the
    port to the JAX package. SAMA runs with ``--flash`` (at S1024 through
    B3-B5, with B1/B2 launched no time), CG and Neumann on the plain
    attention with the fused vector loops."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    argv = SMALL_ARGV + ["--hypergradient", hypergradient]
    argv[argv.index("--seq_len") + 1] = str(seq_len)
    argv[argv.index("--batch_size") + 1] = str(batch)
    if hypergradient == "sama":
        argv.append("--flash")
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = ex.build_engine(ex.parse_args(argv + ["--device", dev]),
                                       **SOLVER_CONFIG[hypergradient])
    for name, st in engines["cpu"].states.items():
        engines["cuda"].states[name]["params"] = {k: v.to("cuda") for k, v in
                                                  st["params"].items()}
    reset, counters = _counters(hypergradient)
    reset()
    for eng in engines.values():
        eng.run()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    used = _used(hypergradient, seq_len, counters)
    assert all((n > 0) == (k in used) for k, n in launches.items()), launches
    err = max(float((engines["cuda"].states[n]["params"][k].cpu() - t).abs().max())
              for n, st in engines["cpu"].states.items() for k, t in st["params"].items())
    log(f"[small] {hypergradient} S{seq_len} B{batch}: card vs CPU after 4+2 steps: max |param "
        f"diff| {err:.3e} (tol 1e-4); launches {launches}")
    assert err <= 1e-4, err
    del engines
    _free()


def slice_phase(hypergradient, meta_periods=2, expected=None, profile=True, seq_len=128,
                batch=32):
    """Data reweighting of the RoBERTa-large encoder at B``batch``
    S``seq_len`` for ``meta_periods`` meta-periods, then (``profile``) one
    more under the profiler. Returns the launch counts of the path's kernels
    over the timed periods; ``expected`` gives exact counts to hold them
    to."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    unroll = 5
    argv = ["--model", "large", "--hypergradient", hypergradient, "--precision", "bf16",
            "--solver_precision", "fp32", "--unroll_steps", str(unroll),
            "--batch_size", str(batch), "--seq_len", str(seq_len), "--device_data",
            "--train_iters", str(unroll * meta_periods), "--train_size", "2048",
            "--meta_size", "512", "--device", "cuda"]
    if hypergradient == "sama":
        argv.append("--flash")
    tag = f"[slice {hypergradient}{'' if seq_len == 128 else f' S{seq_len}'}]"
    log(f"{tag} argv: {' '.join(argv)}; solver config {SOLVER_CONFIG[hypergradient]}")
    t0 = time.time()
    engine = ex.build_engine(ex.parse_args(argv), **SOLVER_CONFIG[hypergradient])
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in engine.states["classifier"]["params"].values())
    log(f"{tag} build_engine {time.time() - t0:.1f} s; classifier parameters {n_params}")
    assert n_params == roberta_large_params(max_len=seq_len), n_params

    losses = {"classifier": [], "reweight": []}
    period_ends = []  # host clock after each reweight step, device synchronised
    for prob in (engine.classifier, engine.reweight):
        orig = prob.one_step_descent

        def record(*a, _orig=orig, _name=prob.name, **kw):
            out = _orig(*a, **kw)
            losses[_name].append(out["loss"].detach())
            if _name == "reweight":
                torch.cuda.synchronize()
                period_ends.append(time.time())
            return out

        prob.one_step_descent = record
    rw_before = {k: t.clone() for k, t in engine.states["reweight"]["params"].items()}

    reset, counters = _counters(hypergradient)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the engine's state, and anything left from before
    reset()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    vals = {k: [float(x) for x in v] for k, v in losses.items()}
    log(f"{tag} losses {json.dumps(vals)}")
    log(f"{tag} counts classifier {engine.classifier.count} reweight {engine.reweight.count}")
    log(f"{tag} launches {launches}")
    periods = [b - a for a, b in zip([t0] + period_ends, period_ends)]
    log(f"{tag} meta-period seconds {periods} (the first includes warm-up); run "
        f"{elapsed:.3f} s; max_memory_allocated {peak / 2**30:.2f} GiB "
        f"({held / 2**30:.2f} GiB allocated when the run started)")
    assert engine.classifier.count == unroll * meta_periods, engine.classifier.count
    assert engine.reweight.count == meta_periods, engine.reweight.count
    assert all(math.isfinite(x) for v in vals.values() for x in v), vals
    assert len(vals["classifier"]) == unroll * meta_periods and len(vals["reweight"]) >= 2
    if expected is None:
        assert all(n > 0 for n in launches.values()), launches
    else:
        assert launches == expected, (launches, expected)
    changed = any(not torch.equal(rw_before[k], t)
                  for k, t in engine.states["reweight"]["params"].items())
    assert changed, "the reweight parameters did not change"
    finite = all(bool(torch.isfinite(t).all())
                 for s in engine.states.values() for t in s["params"].values())
    assert finite, "non-finite parameters after the run"
    if profile:
        profile_period(engine, unroll, tag)
    del engine
    _free()
    return launches


def profile_period(engine, unroll, tag, classify=None):
    """One more meta-period under ``torch.profiler``: device time by kernel
    class (``classify(kernel name)``, by default the port's own kernels and
    matmuls), the flash kernels' split by input dtype, and the device's idle
    share over the period's wall time. The profiler records the card's
    kernels only: the report reads nothing else, and the host's ops of a
    driver-mode period (several hundred thousand) cost the host seconds to
    record and to sort."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.train_iters = unroll
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    return profile_report(prof, wall_ms, tag, classify)


def _device_kernels(prof):
    """``(ms, launches, name)`` of each kernel (and copy) the card ran under
    ``prof``, summed by name from the profiler's raw events: building its
    event tree (``key_averages``) takes the host minutes for a period of a
    million kernels."""
    import torch

    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        out = []
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = getattr(e, "self_cuda_time_total", 0.0)
                out.append((t / 1e3, e.count, e.key))
        return out
    by_name = {}
    for e in results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.duration_ns(), c + 1)
    return [(t / 1e6, c, name) for name, (t, c) in by_name.items()]


def profile_report(prof, wall_ms, tag, classify=None):
    """Device time by kernel class of a finished ``torch.profiler`` run over
    ``wall_ms`` of wall time (``profile_period``'s report); None when the
    profiler recorded no device time."""
    kernels = _device_kernels(prof)
    busy = sum(t for t, _, _ in kernels)
    if busy == 0.0:
        log(f"{tag} [profile] the profiler recorded no device time")
        return

    def own(name):
        m = re.search(r"\(anonymous namespace\)::(\w+)[<(]", name)
        return m.group(1) if m and m.group(1) in KERNEL_SYMBOLS else None

    def kind(name):
        if own(name):
            return KERNEL_SYMBOLS[own(name)]
        if any(w in name.lower() for w in ("gemm", "xmma", "cutlass", "cublas", "matmul")):
            return "matmul"
        return "other"

    by_kind, by_dtype = {}, {}
    for t, c, name in kernels:
        k = (classify or kind)(name)
        by_kind[k] = by_kind.get(k, 0.0) + t
        if k.startswith("flash"):
            # the tensor-core kernels (mma_*) take bf16, the others their type argument
            bf16 = own(name).startswith("mma_") or "__nv_bfloat16" in name
            key = (k, "bf16" if bf16 else "fp32")
            prev = by_dtype.get(key, (0.0, 0))
            by_dtype[key] = (prev[0] + t, prev[1] + c)
    counts = {}
    for _, c, name in kernels:
        if own(name):
            counts[KERNEL_SYMBOLS[own(name)]] = counts.get(KERNEL_SYMBOLS[own(name)], 0) + c
    log(f"{tag} [profile] profiled meta-period: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(c for _, c, _ in kernels)} kernel launches")
    for k, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"{tag} [profile]   {k:14s} {t:9.2f} ms  {t / busy:.3f} of device time")
    for (k, dt), (t, c) in sorted(by_dtype.items()):
        log(f"{tag} [profile]   {k} {dt}: {t:.2f} ms over {c} launches")
    for t, c, name in sorted(kernels, reverse=True)[:15]:
        log(f"{tag} [profile]   {t:9.2f} ms  x{c:<6d} {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": sum(c for _, c, _ in kernels),
            "by_kind": by_kind, "own_launches": counts, "kernels": kernels}


# ---------------------------------------------------------------------------
# mwn: the Meta-Weight-Net flagship (ResNet-32 with BatchNorm under an MLP
# reweighter, darts, unroll 1, fp32), which runs no kernel of the port: its
# convolutions and BatchNorm are cuDNN's through torch.nn.functional, as the
# JAX package's are XLA's
# ---------------------------------------------------------------------------

RESNET32_PARAMS = 466_906
MWN_SMALL_ARGV = ["--batch_size", "8", "--stage_sizes", "1,1,1", "--train_size", "256",
                  "--meta_size", "64", "--train_iters", "3"]


def _mwn_tree_err(a_states, b_states):
    """Largest |difference| over both problems' params and batch_stats."""
    err = 0.0
    for name, a in a_states.items():
        b = b_states[name]
        for coll in ("params", "extra"):
            ta, tb = a[coll], b[coll]
            if coll == "extra":
                ta, tb = ta.get("batch_stats", {}), tb.get("batch_stats", {})
            assert set(ta) == set(tb)
            err = max([err] + [float((ta[k].cpu() - tb[k].cpu()).abs().max()) for k in ta])
    return err


def mwn_small_phase(dtype_name="float64", seed=0):
    """A small MWN run (a 3-block ResNet, B8) on the card and on the CPU
    from the same weights (the ResNet's from ``seed``), in ``dtype_name``:
    3 darts meta-periods, then 2 CG periods (3 iterations, ``hvp_mode``
    "jvp", so that BatchNorm goes through forward-over-reverse). Returns
    the largest difference of both problems' params and batch_stats after
    each part. In float32 a ReLU input within rounding of 0 may take the
    other branch on one side, which changes that step's gradient
    discontinuously, so only the float64 run is held to a bound (1e-9)."""
    import dataclasses

    import numpy as np
    import torch
    from betty_tpu_torch.examples import learning_to_reweight as ex
    from betty_tpu_torch.models import ResNet
    from betty_tpu_torch.utils import tree_map

    dtype = getattr(torch, dtype_name)
    engines = {dev: ex.build_engine(ex.parse_args(MWN_SMALL_ARGV + ["--device", dev]))
               for dev in ("cpu", "cuda")}
    cpu = engines["cpu"]
    cpu.states["classifier"]["params"] = {
        k: t.detach() for k, t in ResNet((1, 1, 1), seed=seed).named_parameters()}
    cpu.states = tree_map(
        lambda t: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t, cpu.states)
    engines["cuda"].states = tree_map(lambda t: t.to("cuda") if torch.is_tensor(t) else t,
                                      cpu.states)
    for eng in engines.values():
        for prob in eng.problems:
            for loader in prob.train_data_loader:
                loader.arrays = (loader.arrays[0].astype(np.dtype(dtype_name)),
                                 *loader.arrays[1:])
    errs = []
    for solver in ("darts", "cg"):
        for eng in engines.values():
            if solver == "cg":
                eng.classifier._config = dataclasses.replace(eng.classifier.config, type="cg",
                                                             cg_iterations=3)
                eng.train_iters = 2
            eng.run()
        torch.cuda.synchronize()
        errs.append(_mwn_tree_err(cpu.states, engines["cuda"].states))
    counts = [(e.classifier.count, e.reweight.count) for e in engines.values()]
    finite = all(bool(torch.isfinite(t).all()) for s in engines["cuda"].states.values()
                 for t in (*s["params"].values(), *s["extra"].get("batch_stats", {}).values()))
    held = dtype_name == "float64"
    log(f"[mwn small] 3-block ResNet B8 {dtype_name} seed {seed}, card vs CPU: max |param or "
        f"batch_stats diff| {errs[0]:.3e} after 3 darts periods, {errs[1]:.3e} after 2 more CG "
        f"periods ({'tol 1e-9' if held else 'reported'}); counts {counts}; finite {finite}")
    assert counts == [(5, 5), (5, 5)] and finite, (counts, finite)
    if held:
        assert max(errs) <= 1e-9, errs
    del engines, cpu
    _free()
    return errs


def _op_class(name):
    """Op class of a CUDA kernel by its name, for the MWN profile."""
    n = name.lower()
    if "batch_norm" in n or "batchnorm" in n or re.search(r"\bbn_", n):
        return "BatchNorm"
    if any(w in n for w in ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm",
                            "cudnn")):
        return "convolution"
    if any(w in n for w in ("gemm", "gemv", "cublas", "cutlass", "matmul", "dot_kernel")):
        return "matmul"
    if "elementwise" in n or "unrolled" in n or "foreach" in n:
        return "elementwise"
    if "reduce" in n:
        return "reduction"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def _wrap_periods(engine):
    """Record the host clock after each reweight step (or, single-level,
    each classifier step), device synchronised; returns the list."""
    import torch

    ends = []
    prob = getattr(engine, "reweight", engine.classifier)
    orig = prob.one_step_descent

    def record(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        ends.append(time.time())
        return out

    prob.one_step_descent = record
    return ends


def _quartiles(xs):
    xs = sorted(xs)
    q = lambda f: xs[min(len(xs) - 1, int(round(f * (len(xs) - 1))))]  # noqa: E731
    return q(0.25), q(0.5), q(0.75)


def mwn_slice_phase(warmup=2, steady=6):
    """The example's defaults on the card (ResNet-32, B128, MWN 100 hidden,
    darts, unroll 1, fp32, SGD/Adam) with the data on the device:
    ``warmup`` meta-periods, then ``steady`` timed ones (median and spread
    of s/meta-period), then one under the profiler (busy and idle share,
    device time by op class, launches); peak memory. No kernel of the port
    may launch."""
    import torch
    from betty_tpu_torch.examples import learning_to_reweight as ex
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    tag = "[mwn slice]"
    argv = ["--device_data", "--device", "cuda", "--train_iters", str(warmup + steady)]
    t0 = time.time()
    engine = ex.build_engine(ex.parse_args(argv))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in engine.states["classifier"]["params"].values())
    log(f"{tag} argv: {' '.join(argv)} (defaults otherwise); build_engine "
        f"{time.time() - t0:.1f} s; classifier parameters {n_params}")
    assert n_params == RESNET32_PARAMS, n_params
    ends = _wrap_periods(engine)
    rw_before = {k: t.clone() for k, t in engine.states["reweight"]["params"].items()}
    stats_before = {k: t.clone()
                    for k, t in engine.states["classifier"]["extra"]["batch_stats"].items()}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fa.reset_launch_counts()
    vec.reset_launch_counts()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    ours = {**{k: f.launches for k, f in fa.KERNELS.items()},
            **{k: getattr(vec, k).launches for k in VECTOR_KERNELS}}
    periods = [b - a for a, b in zip([t0] + ends, ends)]
    q1, med, q3 = _quartiles(periods[warmup:])
    log(f"{tag} meta-period seconds {periods}")
    log(f"{tag} steady s/meta-period over {steady} periods after {warmup}: median {med:.6f}, "
        f"quartiles {q1:.6f} / {q3:.6f} (IQR {q3 - q1:.6f}), min {min(periods[warmup:]):.6f}, "
        f"max {max(periods[warmup:]):.6f}; warm-up {periods[:warmup]}; run {elapsed:.3f} s")
    log(f"{tag} max_memory_allocated {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB allocated "
        f"when the run started); launches of the port's kernels {ours}")
    counts = (engine.classifier.count, engine.reweight.count)
    assert counts == (warmup + steady,) * 2, counts
    assert all(n == 0 for n in ours.values()), ours
    assert any(not torch.equal(rw_before[k], t)
               for k, t in engine.states["reweight"]["params"].items()), "reweight did not move"
    stats = engine.states["classifier"]["extra"]["batch_stats"]
    assert any(not torch.equal(stats_before[k], t) for k, t in stats.items())
    assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
               for t in (*s["params"].values(), *s["extra"].get("batch_stats", {}).values()))
    prof = profile_period(engine, 1, tag, classify=_op_class)
    assert prof is not None and prof["busy_ms"] > 0, "no device time in the profiled period"
    del engine
    _free()


def mwn_baseline_phase(steps=5):
    """``--baseline`` (the classifier alone, plain mean loss) for ``steps``
    steps at the defaults on the card."""
    import torch
    from betty_tpu_torch.examples import learning_to_reweight as ex

    engine = ex.build_engine(ex.parse_args(["--baseline", "--device_data", "--device", "cuda",
                                            "--train_iters", str(steps)]))
    ends = _wrap_periods(engine)
    before = {k: t.clone() for k, t in engine.states["classifier"]["params"].items()}
    t0 = time.time()
    engine.run()
    steps_s = [b - a for a, b in zip([t0] + ends, ends)]
    log(f"[mwn baseline] {steps} classifier steps at B128: seconds {steps_s}")
    assert engine.classifier.count == steps and list(engine.states) == ["classifier"]
    params = engine.states["classifier"]["params"]
    assert all(bool(torch.isfinite(t).all()) for t in params.values())
    assert any(not torch.equal(before[k], t) for k, t in params.items())
    del engine
    _free()


def mwn_entry_phase():
    """``betty_tpu_torch.entry.entry()`` on the card against the CPU from
    the same weights, on its own zero batch and on a random one: losses
    within 1e-5 relative."""
    import torch
    from betty_tpu_torch.entry import entry
    from betty_tpu_torch.utils import tree_map

    step_cpu, args_cpu = entry("cpu")
    step_gpu, _ = entry()
    gen = torch.Generator().manual_seed(0)
    batches = [args_cpu[2:], (torch.randn(32, 32, 32, 3, generator=gen),
                              torch.randint(0, 10, (32,), generator=gen))]
    errs = []
    for images, labels in batches:
        want = step_cpu(*args_cpu[:2], images, labels)
        got = step_gpu(*tree_map(lambda t: t.cuda(), (*args_cpu[:2], images, labels)))
        assert bool(torch.isfinite(got)), got
        errs.append(abs(float(got) - float(want)) / max(abs(float(want)), 1e-30))
        log(f"[mwn entry] loss card {float(got):.8f} CPU {float(want):.8f} (relative "
            f"difference {errs[-1]:.3e}, tol 1e-5)")
    assert max(errs) <= 1e-5, errs


def mwn_phase():
    t0 = time.time()
    mwn_small_phase("float64")
    for seed in range(4):
        mwn_small_phase("float32", seed)
    mwn_slice_phase()
    mwn_baseline_phase()
    mwn_entry_phase()
    log(f"[mwn] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# compiled: compiled blocks (betty_tpu_torch/compile.py), one CUDA graph
# replay a meta-period, against driver mode on the same card
# ---------------------------------------------------------------------------


def adam_rounding_check(n=1 << 20):
    """Driver-mode Adam on the card against optax's arithmetic (numpy
    float32, every operation rounded once): the port's update, whose bias
    corrections are 0-d device tensors, and the same expression with them
    as Python numbers, which CUDA divides by as products with their
    reciprocals. The divisions themselves (m / bc1, n / bc2) are held: none
    of the port's may differ; the whole update is reported (it also holds
    the card's square root). Returns the counts by Adam count."""
    import numpy as np
    import torch
    from betty_tpu_torch import optim

    rs = np.random.RandomState(0)
    g, p = (rs.randn(n).astype(np.float32) for _ in range(2))
    mu = (0.1 * rs.randn(n)).astype(np.float32)
    nu = (0.01 * rs.rand(n)).astype(np.float32)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 1e-3
    out = {}
    for count in (1, 10, 1000):
        f = np.float32
        m1 = f(1 - b1) * g + f(b1) * mu
        n1 = f(1 - b2) * (g * g) + f(b2) * nu
        bc1 = f(1.0) - f(b1) ** f(count)
        bc2 = f(1.0) - f(b2) ** f(count)
        want = -((m1 / bc1) / (np.sqrt(n1 / bc2) + f(eps))) * f(lr)
        cuda = {k: torch.from_numpy(v).cuda() for k, v in (("g", g), ("p", p), ("mu", mu),
                                                            ("nu", nu))}
        opt = optim.adam(lr=lr)
        upd, _ = opt.update({"w": cuda["g"]}, {"count": count - 1, "mu": {"w": cuda["mu"]},
                                               "nu": {"w": cuda["nu"]}}, {"w": cuda["p"]})
        m_t = (1 - b1) * cuda["g"] + b1 * cuda["mu"]
        n_t = (1 - b2) * (cuda["g"] * cuda["g"]) + b2 * cuda["nu"]
        old = -((m_t / float(bc1)) / (torch.sqrt(n_t / float(bc2)) + eps)) * lr

        def differ(a, b):
            return int((a.cpu().numpy() != b).sum())

        bct = [torch.full((), float(b), device="cuda") for b in (bc1, bc2)]
        div = {"tensor": differ(m_t / bct[0], m1 / bc1) + differ(n_t / bct[1], n1 / bc2),
               "number": differ(m_t / float(bc1), m1 / bc1) + differ(n_t / float(bc2), n1 / bc2)}
        out[count] = (div["tensor"], div["number"], differ(upd["w"], want), differ(old, want))
        log(f"[compiled] Adam on the card against optax's float32 arithmetic, count {count}: "
            f"m / bc1 and n / bc2 differ in {div['tensor']} of {2 * n} elements with the bias "
            f"corrections as 0-d device tensors (the port), {div['number']} as Python numbers "
            f"(a product with the reciprocal on CUDA); the whole update in {out[count][2]} / "
            f"{out[count][3]} of {n}")
    assert all(v[0] == 0 for v in out.values()), out
    return out


def _state_err(a_states, b_states):
    """Largest |difference| over every tensor of two engines' states (inf
    where either holds a NaN); the integer leaves must be equal."""
    import torch
    from betty_tpu_torch.compile import _paths

    err = 0.0
    for name, a in a_states.items():
        pa, pb = dict(_paths(a)), dict(_paths(b_states[name]))
        assert set(pa) == set(pb), name
        for k, x in pa.items():
            if torch.is_tensor(x):
                d = (x.double() - pb[k].double().to(x.device)).abs()
                err = max(err, float(torch.nan_to_num(d, nan=math.inf).max()))
            else:
                assert x == pb[k], (name, k, x, pb[k])
    return err


class _CaptureWatch:
    """Reads the launch counters around each capture (the launches recorded
    into the graph, which every replay repeats) and the values the runner
    writes before each period."""

    def __init__(self, counters):
        from betty_tpu_torch import compile as comp

        self.comp, self.counters = comp, counters
        self.per_replay, self.written = {}, []
        self._capture, self._write = comp.BlockRunner._capture, comp._Slots.write

    def __enter__(self):
        watch = self

        def capture(runner, collected):
            before = {k: c.launches for k, c in watch.counters.items()}
            watch._capture(runner, collected)
            watch.per_replay = {k: c.launches - before[k] for k, c in watch.counters.items()}

        def write(slots, r):
            out = watch._write(slots, r)
            watch.written.append(out)
            return out

        self.comp.BlockRunner._capture, self.comp._Slots.write = capture, write
        return self

    def __exit__(self, *exc):
        self.comp.BlockRunner._capture, self.comp._Slots.write = self._capture, self._write
        return False


COMPILED_SMALL = {  # name: (bert example argv, solver, periods); SAMA gathers its batches
    # on the device inside the graph, CG and Neumann copy host batches in
    "sama S16": (["--seq_len", "16", "--flash", "--device_data"], "sama", 4),
    "sama S1024": (["--seq_len", "1024", "--flash", "--batch_size", "2", "--device_data"],
                   "sama", 3),
    "cg": ([], "cg", 3),
    "neumann": ([], "neumann", 3),
}


def _compiled_small_engine(name, compiled):
    import torch
    from betty_tpu_torch import optim
    from betty_tpu_torch.utils import tree_map

    if name == "mwn f64":
        from betty_tpu_torch.examples import learning_to_reweight as ex

        argv = MWN_SMALL_ARGV + ["--device", "cuda", "--train_iters", "4", "--lr_milestones",
                                 "2", "--device_data"]
        engine = ex.build_engine(ex.parse_args(argv + (["--compile_blocks"] if compiled
                                                       else [])))
        engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                                 and t.is_floating_point() else t, engine.states)
        for prob in engine.problems:
            for loader in prob.train_data_loader:
                loader.arrays = (loader.arrays[0].double(), *loader.arrays[1:])
        periods, hypergradient = 4, "mwn"
    else:
        from betty_tpu_torch.examples import bert_data_reweighting as ex

        extra, hypergradient, periods = COMPILED_SMALL[name]
        argv = SMALL_ARGV + ["--hypergradient", hypergradient, "--device", "cuda"]
        flags = iter(extra)
        for flag in flags:
            if flag in ("--flash", "--device_data"):
                argv.append(flag)
            else:
                argv[argv.index(flag) + 1] = next(flags)
        argv[argv.index("--dropout") + 1] = "0.1"
        argv[argv.index("--train_iters") + 1] = str(2 * periods)
        engine = ex.build_engine(ex.parse_args(argv + (["--compile_blocks"] if compiled
                                                       else [])),
                                 **SOLVER_CONFIG[hypergradient])
        # a learning rate that changes within the run: a per-step value
        engine.classifier.optimizer.schedule = optim.step_lr(2e-5, step_size=3, gamma=0.5)
    engine.config.block_periods = 1
    return engine, hypergradient, periods


def compiled_small_phase(name):
    """A small run compiled (one replay a period) against driver mode, both
    on the card from the same weights, and driver mode against itself (the
    spread that cuDNN's or cuBLAS's choices may leave): compiled must be
    within that spread (bit for bit where it is 0). Holds the runner's
    counts (one capture, one replay a period, no driver fallback), each
    kernel's launches a replay against driver mode's a period, and that the
    dropout seeds of consecutive replays differ."""
    import torch

    # cuDNN's default convolution algorithms sum with atomics: two float64
    # driver runs of the MWN differ by about 4e-15, more or less from run to
    # run, so that run takes the deterministic ones and is held bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = name == "mwn f64"
    runs = {}
    for label in ("driver", "driver again", "compiled"):
        engine, hypergradient, periods = _compiled_small_engine(name, label == "compiled")
        reset, counters = _counters("sama" if hypergradient == "mwn" else hypergradient)
        with _CaptureWatch(counters) as watch:
            reset()
            engine.run()
            torch.cuda.synchronize()
        runs[label] = (engine, {k: c.launches for k, c in counters.items()}, watch)
    torch.backends.cudnn.deterministic = deterministic
    (driver, d_launch, _), (again, _, _), (comp, _, watch) = (runs[k] for k in runs)
    spread = _state_err(driver.states, again.states)
    err = _state_err(driver.states, comp.states)
    runner = comp.block_runner
    seeds = [w[2] for w in watch.written]
    fresh = all(a != b for r in range(len(seeds) - 1) for a, b in zip(seeds[r], seeds[r + 1]))
    log(f"[compiled small] {name} ({'device' if runner.fastpath else 'host'} loaders): "
        f"compiled vs driver max |state diff| {err:.3e}, driver vs "
        f"driver {spread:.3e} (tolerance: that spread; cuDNN deterministic "
        f"{name == 'mwn f64'}); captures {runner.captures}, replays "
        f"{runner.replays} of {periods} periods, capture {runner.capture_seconds:.2f} s; "
        f"launches a replay {watch.per_replay}, driver {d_launch} over {periods} periods; "
        f"{len(seeds[0]) if seeds else 0} dropout generators a period, fresh seeds every "
        f"replay: {fresh}")
    assert err <= spread, (err, spread)
    assert runner.captures == 1 and runner.replays == runner.periods_run == periods
    assert all(watch.per_replay[k] * periods == d_launch[k] for k in d_launch), \
        (watch.per_replay, d_launch)
    if hypergradient != "mwn":
        used = _used(hypergradient, 1024 if "1024" in name else 16, d_launch)
        assert all((d_launch[k] > 0) == (k in used) for k in d_launch), d_launch
        assert seeds and fresh
    del runs, driver, again, comp, runner
    _free()
    return err, spread


def _timed_run(engine, unroll, periods, tag, classify=None, profiled="all", offset=0):
    """Run ``periods`` meta-periods, the host clock read (device
    synchronised) at the end of each, the last one under the profiler
    (``profiled``: "all" host ops and the card's kernels, "card" the
    kernels alone, whose trace the host processes faster; None: no
    profile). A period ends where the global step less ``offset`` is a
    multiple of ``unroll``. Returns ``(seconds of each period, profile
    report or None, peak GiB)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = {"all": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  "card": [ProfilerActivity.CUDA]}.get(profiled)

    ends, prof = [], {}
    validate = engine.maybe_validate_checkpoint

    def hook(window=1):
        stop = validate(window)
        if (engine.global_step - offset) % unroll == 0:
            torch.cuda.synchronize()
            ends.append(time.time())
            if len(ends) == periods - 1 and activities:
                prof["p"] = profile(activities=activities)
                prof["p"].__enter__()
                prof["t0"] = time.time()
            elif len(ends) == periods and activities:
                prof["p"].__exit__(None, None, None)
        return stop

    engine.maybe_validate_checkpoint = hook
    engine.train_iters = unroll * periods
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    seconds = [b - a for a, b in zip([t0] + ends, ends)]
    report = None
    if activities:
        report = profile_report(prof["p"], (ends[-1] - prof["t0"]) * 1e3, tag, classify)
    return seconds, report, peak


def _cell_line(tag, seconds, report, peak, skip):
    steady = seconds[skip:-1]
    q1, med, q3 = _quartiles(steady)
    busy = report["busy_ms"] if report else float("nan")
    wall = report["wall_ms"] if report else float("nan")
    log(f"{tag} s/meta-period {seconds}; steady (periods {skip + 1}..{len(seconds) - 1}) "
        f"median {med:.6f} quartiles {q1:.6f} / {q3:.6f}; profiled period wall {wall:.1f} ms "
        f"busy {busy:.1f} ms idle share {1 - busy / wall:.3f}; kernel launches "
        f"{report['launches'] if report else 'not read'}; peak {peak:.3f} GiB")
    return {"median": med, "q1": q1, "q3": q3, "busy_ms": busy, "wall_ms": wall,
            "peak_gib": peak}


def compiled_mwn_cell(warmup=2, steady=5):
    """The MWN flagship (ResNet-32 B128, darts, unroll 1, fp32, data on the
    device), driver mode and compiled blocks (one replay a period) in
    turns: driver, compiled, compiled, driver; ``warmup`` + ``steady``
    timed periods and one profiled each."""
    import torch
    from betty_tpu_torch.examples import learning_to_reweight as ex

    out, finals = {}, {}
    for i, mode in enumerate(("driver", "compiled", "compiled", "driver")):
        argv = ["--device_data", "--device", "cuda"] + (["--compile_blocks"]
                                                        if mode == "compiled" else [])
        engine = ex.build_engine(ex.parse_args(argv))
        engine.config.block_periods = 1
        tag = f"[compiled mwn {mode} {i}]"
        seconds, report, peak = _timed_run(engine, 1, warmup + steady + 1, tag, _op_class,
                                           profiled="card")
        out.setdefault(mode, []).append(_cell_line(tag, seconds, report, peak, warmup))
        if mode == "compiled":
            r = engine.block_runner
            log(f"{tag} captures {r.captures}, replays {r.replays}, capture (two warm-up "
                f"periods and the capture) {r.capture_seconds:.3f} s")
            assert r.captures == 1 and r.replays == warmup + steady + 1
        assert engine.classifier.count == warmup + steady + 1
        assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
                   for t in s["params"].values())
        finals.setdefault(mode, []).append({n: {k: t.cpu() for k, t in s["params"].items()}
                                            for n, s in engine.states.items()})
        del engine
        _free()
    diff = {f"{a} {i} vs {b} {j}": _state_err(finals[a][i], finals[b][j])
            for a, i, b, j in (("driver", 0, "driver", 1), ("compiled", 0, "compiled", 1),
                               ("driver", 0, "compiled", 0))}
    log(f"[compiled mwn] max |param diff| after {warmup + steady + 1} periods: {diff} "
        "(reported: cuDNN may choose other algorithms from run to run)")
    return out


def compiled_sama_cell():
    """SAMA reweighting of the RoBERTa-large encoder at B32 S128 with
    ``--flash`` (the north star), driver mode and then compiled blocks: a
    first period (for compiled blocks: the warm-up periods and the
    capture), 2 timed ones and a profiled one each. B1/B2 launches a replay must
    equal driver mode's a period."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    unroll = 5
    argv = ["--model", "large", "--hypergradient", "sama", "--precision", "bf16",
            "--solver_precision", "fp32", "--unroll_steps", str(unroll), "--batch_size", "32",
            "--seq_len", "128", "--device_data", "--train_size", "2048", "--meta_size", "512",
            "--device", "cuda", "--flash"]
    out, finals = {}, {}
    for mode, periods in (("driver", 3), ("compiled", 3)):  # cut from 4 for the time limit
        tag = f"[compiled sama S128 {mode}]"
        engine = ex.build_engine(ex.parse_args(argv + (["--compile_blocks"]
                                                       if mode == "compiled" else [])))
        engine.config.block_periods = 1
        reset, counters = _counters("sama")
        with _CaptureWatch(counters) as watch:
            reset()
            seconds, report, peak = _timed_run(engine, unroll, periods, tag, profiled="card")
        launches = {k: c.launches for k, c in counters.items()}
        out[mode] = _cell_line(tag, seconds, report, peak, 1)
        per_period = {k: v // periods for k, v in launches.items()}
        if mode == "compiled":
            r = engine.block_runner
            per_period = watch.per_replay
            log(f"{tag} captures {r.captures}, replays {r.replays}, capture (two warm-up "
                f"periods and the capture) {r.capture_seconds:.3f} s; launches a replay "
                f"{watch.per_replay}; in the profiled replay "
                f"{report['own_launches'] if report else 'not read'}")
            assert r.captures == 1 and r.replays == periods
        else:
            assert launches == {k: v * periods // 2 for k, v in SAMA_S128.items()}, launches
        out[mode]["launches"] = per_period
        assert per_period == {k: v // 2 for k, v in SAMA_S128.items()}, per_period
        assert engine.classifier.count == unroll * periods
        assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
                   for t in s["params"].values())
        finals[mode] = {n: {k: t.cpu() for k, t in s["params"].items()}
                        for n, s in engine.states.items()}
        del engine
        _free()
    out["param_diff"] = _state_err(finals["driver"], finals["compiled"])
    log(f"[compiled sama S128] compiled vs driver after {periods} periods: max |param diff| "
        f"{out['param_diff']:.3e} (reported)")
    return out


def compiled_phase():
    t0 = time.time()
    adam_rounding_check()
    for name in list(COMPILED_SMALL) + ["mwn f64"]:
        compiled_small_phase(name)
    compiled_mwn_cell()
    compiled_sama_cell()
    log(f"[compiled] phase done in {time.time() - t0:.1f} s")



# ---------------------------------------------------------------------------
# itd: iterative differentiation (IterativeProblem) and the reinforce solver
# on the MWN flagship, in driver mode and inside compiled blocks
# ---------------------------------------------------------------------------


def mwn_variant(argv, variant, engine_config=None):
    """The MWN example's engine (``build_engine`` on ``argv``) rebuilt from
    its own pieces through the public API as ``variant``: "itd" (the
    classifier an ``IterativeProblem`` carrying ``Classifier.training_step``
    and the reweighter ``Config(first_order=False)``: its meta-gradient is
    the exact derivative through the classifier's SGD steps, Meta-Weight-
    Net's own), "reinforce" (both problems' ``Config(type="reinforce")``,
    4 samples by default) or "darts" (the example's own problems), under
    ``engine_config`` (default: the example's)."""
    import dataclasses

    import betty_tpu_torch
    from betty_tpu_torch.examples import learning_to_reweight as ex

    base = ex.build_engine(ex.parse_args(argv))
    clf, rw = base.classifier, base.reweight
    if variant == "itd":
        class ITDClassifier(betty_tpu_torch.IterativeProblem):
            training_step = ex.Classifier.training_step

        clf_cls, clf_cfg = ITDClassifier, clf.config
        rw_cfg = dataclasses.replace(rw.config, first_order=False)
    elif variant == "reinforce":
        clf_cls = ex.Classifier
        clf_cfg = dataclasses.replace(clf.config, type="reinforce")
        rw_cfg = dataclasses.replace(rw.config, type="reinforce")
    elif variant == "darts":
        clf_cls, clf_cfg, rw_cfg = ex.Classifier, clf.config, rw.config
    else:
        raise ValueError(variant)
    classifier = clf_cls(name="classifier", module=clf.module_fn, optimizer=clf.optimizer,
                         train_data_loader=clf.train_data_loader[0], config=clf_cfg)
    reweight = ex.Reweight(name="reweight", module=rw.module_fn, optimizer=rw.optimizer,
                           train_data_loader=rw.train_data_loader[0], config=rw_cfg)
    engine = ex.MWNEngine(config=engine_config or base.config, problems=[reweight, classifier],
                          dependencies={"u2l": {reweight: [classifier]},
                                        "l2u": {classifier: [reweight]}},
                          device=base.device)
    engine.test_data = base.test_data
    return engine


def _injected_directions(rng, i, like):
    """reinforce's directions drawn on the host from the step's seed, the
    same on every device (the solver's own generator draws differently on
    the CPU and on the card)."""
    import numpy as np
    import torch
    from betty_tpu_torch.utils import fold_in

    r = np.random.RandomState(fold_in(rng, i) % 2**32)
    return {k: torch.from_numpy(r.standard_normal(tuple(x.shape))).to(x.device, x.dtype)
            for k, x in like.items()}


ITD_SMALL = (("itd", 1), ("itd", 3), ("reinforce", 1))  # (variant, unroll_steps)
ITD_FULL = (("itd", 1), ("itd", 5), ("reinforce", 1))
ITD_PERIODS = 4


def _itd_small_engine(variant, unroll, device, compiled, states=None):
    """The small MWN (3-block ResNet, B8, data on the device) as ``variant``
    in float64, ``ITD_PERIODS`` meta-periods, an LR milestone inside the
    run, one replay a period; ``states`` (CPU tensors) replace its own."""
    import torch
    from betty_tpu_torch.utils import tree_map

    argv = MWN_SMALL_ARGV + ["--device", device, "--unroll_steps", str(unroll), "--train_iters",
                             str(ITD_PERIODS * unroll), "--lr_milestones", "2", "--device_data"]
    engine = mwn_variant(argv + (["--compile_blocks"] if compiled else []), variant)
    engine.config.block_periods = 1
    if states is None:
        states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                          else t, engine.states)
    engine.states = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, states)
    for prob in engine.problems:
        for loader in prob.train_data_loader:
            loader.arrays = (loader.arrays[0].double(), *loader.arrays[1:])
    return engine


def itd_small_phase(variant, unroll):
    """The small float64 MWN as ``variant``: the card against the CPU from
    the same weights (reinforce with host-drawn directions on both sides),
    within 1e-9; then compiled blocks against driver mode on the card, bit
    for bit (reinforce with its own generator, which joins the graph's
    pool: fresh directions every replay, driver mode's). cuDNN runs its
    deterministic algorithms."""
    import functools

    import torch
    from betty_tpu_torch.hypergradient import jvp_fn_mapping, reinforce

    tag = f"[itd small] {variant} unroll {unroll}"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    own = jvp_fn_mapping["reinforce"]
    try:
        jvp_fn_mapping["reinforce"] = functools.partial(reinforce,
                                                        directions=_injected_directions)
        cpu = _itd_small_engine(variant, unroll, "cpu", False)
        states = cpu.states
        for label, device in (("cpu", "cpu"), ("card", "cuda")):
            engine = _itd_small_engine(variant, unroll, device, False, states)
            engine.run()
            runs[label] = engine
        jvp_fn_mapping["reinforce"] = own
        if variant == "reinforce":
            runs["driver"] = _itd_small_engine(variant, unroll, "cuda", False, states)
            runs["driver"].run()
        else:
            runs["driver"] = runs["card"]
        with _CaptureWatch({}) as watch:
            runs["compiled"] = _itd_small_engine(variant, unroll, "cuda", True, states)
            runs["compiled"].run()
        torch.cuda.synchronize()
    finally:
        jvp_fn_mapping["reinforce"] = own
        torch.backends.cudnn.deterministic = deterministic
    card_err = _mwn_tree_err(runs["cpu"].states, runs["card"].states)
    comp_err = _state_err(runs["driver"].states, runs["compiled"].states)
    runner = runs["compiled"].block_runner
    seeds = [w[2] for w in watch.written]
    fresh = all(a != b for r in range(len(seeds) - 1) for a, b in zip(seeds[r], seeds[r + 1]))
    counts = {k: (e.classifier.count, e.reweight.count) for k, e in runs.items()}
    moved = _mwn_tree_err(states, runs["card"].states)
    finite = all(bool(torch.isfinite(t).all()) for e in runs.values() for s in e.states.values()
                 for t in s["params"].values())
    log(f"{tag}: card vs CPU max |param or batch_stats diff| {card_err:.3e} (tol 1e-9; moved "
        f"{moved:.3e}); compiled vs driver on the card max |state diff| {comp_err:.3e} (bit for "
        f"bit); captures {runner.captures}, replays {runner.replays} of {runner.periods_run} "
        f"periods, capture {runner.capture_seconds:.2f} s; generators a period "
        f"{len(seeds[0]) if seeds else 0}, fresh seeds every replay {fresh}; counts {counts}; "
        f"finite {finite}")
    want = (ITD_PERIODS * unroll, ITD_PERIODS)
    assert all(c == want for c in counts.values()), counts
    assert finite and moved > 0 and card_err <= 1e-9 and comp_err == 0.0, (card_err, comp_err)
    assert runner.captures == 1 and runner.replays == runner.periods_run >= ITD_PERIODS - 1
    assert runner.itd_names == ({"classifier"} if variant == "itd" else set())
    if variant == "reinforce":
        assert seeds and len(seeds[0]) == 1 and fresh, seeds
    del runs, cpu, runner
    _free()
    return card_err, comp_err


def _fixed_losses(engine):
    """Both problems' losses at the engine's parameters on fixed batches
    (the first ``batch_size`` rows of each loader's arrays), no graph."""
    import torch

    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    out = {}
    with torch.no_grad():
        for p in engine.problems:
            ld = p.train_data_loader[0]
            batch = tuple(torch.as_tensor(a[:ld.batch_size]).to(engine.device)
                          for a in ld.arrays)
            out[p.name] = float(p.eval_loss(ctx, batch)[0])
    return out


def _param_norm(states, name):
    import torch

    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in states[name]["params"].values())))


def itd_full_cell(variant, unroll, warmup=1, steady=1):
    """The flagship's defaults (ResNet-32 B128, fp32, TF32 off, SGD 0.1
    nesterov with weight decay 5e-4 under a MultiStepLR at the reference's
    milestones 10000 and 13000, Adam 1e-5, data on the device) as
    ``variant`` at ``unroll``: driver mode, then compiled blocks (one replay
    a period), ``warmup`` + ``steady`` timed periods and one profiled each.
    Reports the period, busy and idle share, launches, peak memory, the
    capture, and the parameters' difference between the modes with both
    runs' loss and parameter norms (float32 cuDNN is not repeatable)."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    argv = ["--device_data", "--device", "cuda", "--unroll_steps", str(unroll),
            "--lr_milestones", "10000,13000"]
    periods = warmup + steady + 1
    out, finals = {}, {}
    for mode in ("driver", "compiled"):
        tag = f"[itd full] {variant} unroll {unroll} {mode}"
        engine = mwn_variant(argv + (["--compile_blocks"] if mode == "compiled" else []),
                             variant)
        engine.config.block_periods = 1
        fa.reset_launch_counts()
        vec.reset_launch_counts()
        seconds, report, peak = _timed_run(engine, unroll, periods, tag, _op_class,
                                           profiled="card")
        ours = {**{k: f.launches for k, f in fa.KERNELS.items()},
                **{k: getattr(vec, k).launches for k in VECTOR_KERNELS}}
        out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        if mode == "compiled":
            r = engine.block_runner
            out[mode]["capture_s"] = r.capture_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}, capture (two warm-up "
                f"periods and the capture) {r.capture_seconds:.3f} s; ITD problems in the "
                f"period {sorted(r.itd_names)}")
            assert r.captures == 1 and r.replays == periods
        losses = _fixed_losses(engine)
        norms = {n: _param_norm(engine.states, n) for n in engine.states}
        out[mode].update(losses=losses, norms=norms)
        log(f"{tag} losses on fixed batches {losses}; parameter norms {norms}; launches of "
            f"the port's kernels {ours}")
        assert engine.classifier.count == unroll * periods and engine.reweight.count == periods
        assert all(math.isfinite(v) for v in losses.values()), losses
        assert all(n == 0 for n in ours.values()), ours
        assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
                   for t in s["params"].values())
        finals[mode] = {n: {k: t.cpu() for k, t in s["params"].items()}
                        for n, s in engine.states.items()}
        del engine
        _free()
    out["param_diff"] = _state_err(finals["driver"], finals["compiled"])
    log(f"[itd full] {variant} unroll {unroll}: compiled vs driver after {periods} periods: max "
        f"|param diff| {out['param_diff']:.3e} (reported: float32 cuDNN is not repeatable)")
    return out


def itd_profile_dir_check():
    """``EngineConfig.profile_dir`` on the card: the small MWN as ITD, in
    driver mode and compiled, each writes a trace that holds the card's
    kernels."""
    import glob
    import shutil

    for mode in ("driver", "compiled"):
        path = os.path.join(ROOT, "build", "itd_trace", mode)
        shutil.rmtree(path, ignore_errors=True)
        engine = _itd_small_engine("itd", 1, "cuda", mode == "compiled")
        engine.config.profile_dir = path
        engine.run()
        files = glob.glob(os.path.join(path, "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        kernels = text.count('"cat": "kernel"')
        log(f"[itd profile_dir] {mode}: {len(files)} trace file(s) in build/itd_trace/{mode}, "
            f"{len(text)} bytes, {kernels} kernel events")
        assert len(files) == 1 and kernels > 0, (files, kernels)
        del engine
        _free()


def itd_phase():
    t0 = time.time()
    for variant, unroll in ITD_SMALL:
        itd_small_phase(variant, unroll)
    itd_profile_dir_check()
    for variant, unroll in ITD_FULL:
        itd_full_cell(variant, unroll)
    log(f"[itd] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# checkpoint: engine checkpoints and auto_resume (betty_tpu_torch/checkpoint.py)
# in driver mode and around compiled blocks
# ---------------------------------------------------------------------------

CKPT_SMALL = (("darts", 3), ("itd", 3))  # (variant, unroll_steps): darts under roll_back
CKPT_CUT, CKPT_TOTAL = 7, 12  # 7 = 2 x 3 + 1: the cut is mid-unroll
# the north star's argv (RoBERTa-large at B32 S128, SAMA, bf16 steps, fp32
# solver passes, unroll 5, dropout 0.1, data on the device)
SAMA_S128_ARGV = ["--model", "large", "--hypergradient", "sama", "--precision", "bf16",
                  "--solver_precision", "fp32", "--unroll_steps", "5", "--batch_size", "32",
                  "--seq_len", "128", "--device_data", "--train_size", "2048",
                  "--meta_size", "512", "--device", "cuda"]


def _ckpt_small_engine(variant, unroll, compiled, iters, path=None, auto=False, device="cuda"):
    """The small MWN (3-block ResNet, B8, data on the device, a MultiStepLR
    milestone after the cut) in float64 as ``variant`` ("darts" under
    ``roll_back``, or "itd"), ``iters`` iterations; with ``path`` it saves
    every ``CKPT_CUT`` steps there, with ``auto`` it starts from there."""
    import torch
    from betty_tpu_torch import EngineConfig
    from betty_tpu_torch.utils import tree_map

    argv = MWN_SMALL_ARGV + ["--device", device, "--unroll_steps", str(unroll),
                             "--lr_milestones", "9", "--device_data"]
    config = EngineConfig(train_iters=iters, valid_step=0, roll_back=variant == "darts",
                          compile_blocks=compiled, checkpoint_dir=path,
                          checkpoint_step=CKPT_CUT if path else 0, auto_resume=auto)
    engine = mwn_variant(argv, variant, config)
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    for prob in engine.problems:
        for loader in prob.train_data_loader:
            loader.arrays = (loader.arrays[0].double(), *loader.arrays[1:])
    return engine


def checkpoint_small_phase(variant, unroll, compiled, device="cuda"):
    """The small float64 MWN as ``variant``, cut at ``CKPT_CUT`` (mid-unroll:
    darts with a live roll-back cache, ITD with one recorded batch), saved,
    and resumed by a fresh engine through ``auto_resume`` to ``CKPT_TOTAL``:
    params, batch statistics and optimizer state equal the uninterrupted
    run's bit for bit. cuDNN runs its deterministic algorithms."""
    import tempfile

    import torch

    mode = "compiled" if compiled else "driver"
    tag = f"[checkpoint small] {variant} unroll {unroll} {mode}"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as path:
            full = _ckpt_small_engine(variant, unroll, compiled, CKPT_TOTAL, device=device)
            full.run()
            _ckpt_small_engine(variant, unroll, compiled, CKPT_CUT, path, device=device).run()
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            resumed = _ckpt_small_engine(variant, unroll, compiled, CKPT_TOTAL, path, True,
                                         device=device)
            resumed.run()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err = _state_err(full.states, resumed.states)
    counts = (resumed.classifier.count, resumed.reweight.count)
    runner = resumed.block_runner
    log(f"{tag}: cut at {meta['global_step']} (roll-back caches {meta['rollback_cached']}, "
        f"unroll recorded {meta.get('unroll_recorded', {})}); resumed vs uninterrupted max "
        f"|state diff| {err:.3e} (bit for bit); counts {counts}; resumed blocks "
        f"{runner.periods_run if runner else 0} periods")
    assert meta["global_step"] == CKPT_CUT and counts == (CKPT_TOTAL, CKPT_TOTAL // unroll)
    if variant == "darts":
        assert meta["rollback_cached"] == ["classifier"], meta
    else:
        assert meta["unroll_recorded"] == {"classifier": CKPT_CUT % unroll}, meta
    if compiled:
        assert runner.periods_run >= 1 and full.block_runner.periods_run >= 1
    assert err == 0.0, err
    del full, resumed, runner
    _free()
    return err


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _timed_io(engine, name, record):
    """Wrap ``engine.<name>`` (save or load) to record its seconds (device
    synchronised), the memory it held and the peak while it ran."""
    import torch

    orig = getattr(engine, name)

    def timed(path):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        orig(path)
        torch.cuda.synchronize()
        record[name] = {"s": time.perf_counter() - t0, "held_gib": held / 2**30,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    setattr(engine, name, timed)


def sama_checkpoint_cell(periods=2, cut=1):
    """The north star compiled (``--flash``): ``periods`` meta-periods
    uninterrupted; then ``cut`` periods that save at their block boundary
    and stop, and a fresh engine resumed by ``auto_resume`` to ``periods``
    (a new runner: warm-up and capture). Parameters and the integer leaves
    equal bit for bit. Reports the checkpoint's bytes, the seconds to save
    and to restore, and the memory held and peak while saving."""
    import tempfile

    import torch
    from betty_tpu_torch.compile import _ints
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    unroll = 5
    finals, io = {}, {}
    with tempfile.TemporaryDirectory() as path:
        for label, iters in (("uninterrupted", periods * unroll), ("cut", cut * unroll),
                             ("resumed", periods * unroll)):
            engine = ex.build_engine(ex.parse_args(
                SAMA_S128_ARGV + ["--flash", "--compile_blocks", "--train_iters", str(iters)]))
            if label != "uninterrupted":
                engine.config.checkpoint_dir = path
                engine.config.checkpoint_step = cut * unroll
                engine.config.auto_resume = label == "resumed"
                _timed_io(engine, "save_checkpoint" if label == "cut" else "load_checkpoint", io)
            t0 = time.time()
            engine.run()
            torch.cuda.synchronize()
            r = engine.block_runner
            log(f"[checkpoint sama S128] {label}: {engine.global_step} iterations in "
                f"{time.time() - t0:.2f} s, {r.periods_run} periods in blocks, captures "
                f"{r.captures}, capture {r.capture_seconds:.2f} s")
            if label == "cut":
                io["bytes"] = _dir_bytes(path)
                io["files"] = sorted(os.listdir(path))
            assert engine.classifier.count == iters
            assert r.captures == (engine.device.type == "cuda")
            finals[label] = {n: {"params": {k: t.cpu() for k, t in s["params"].items()},
                                 "ints": _ints(s)}
                             for n, s in engine.states.items()}
            del engine, r
            _free()
    err = _state_err({n: f["params"] for n, f in finals["uninterrupted"].items()},
                     {n: f["params"] for n, f in finals["resumed"].items()})
    ints_equal = all(finals["uninterrupted"][n]["ints"] == finals["resumed"][n]["ints"]
                     for n in finals["resumed"])
    save, load = io["save_checkpoint"], io["load_checkpoint"]
    log(f"[checkpoint sama S128] checkpoint at {cut * unroll}: {io['bytes']} bytes on disk "
        f"({io['bytes'] / 2**30:.3f} GiB; {io['files']}); save {save['s']:.3f} s (held "
        f"{save['held_gib']:.2f} GiB, peak while saving {save['peak_gib']:.2f} GiB); restore "
        f"{load['s']:.3f} s (peak {load['peak_gib']:.2f} GiB); resumed vs uninterrupted after "
        f"{periods} periods: max |param diff| {err:.3e} (bit for bit), integer leaves equal "
        f"{ints_equal}")
    assert err == 0.0 and ints_equal, (err, ints_equal)
    return {"bytes": io["bytes"], "save_s": save["s"], "restore_s": load["s"],
            "save_peak_gib": save["peak_gib"], "err": err}


def mwn_checkpoint_cell(periods=10, cut=5, warmup=3):
    """The MWN flagship (ResNet-32 B128, float32, compiled, one replay a
    period) with ``cudnn.deterministic``: ``periods`` uninterrupted, then
    ``cut`` saved and resumed to ``periods`` by ``auto_resume``; the two are
    compared on fixed-batch losses (and parameters). Beside them the same
    ``periods`` with cuDNN's default algorithms: the period and device time
    that determinism costs."""
    import tempfile

    import torch
    from betty_tpu_torch.examples import learning_to_reweight as ex

    argv = ["--device_data", "--device", "cuda", "--compile_blocks"]
    deterministic = torch.backends.cudnn.deterministic
    out, finals, losses = {}, {}, {}
    try:
        with tempfile.TemporaryDirectory() as path:
            for label, det in (("deterministic", True), ("cut", True), ("resumed", True),
                               ("default", False)):
                torch.backends.cudnn.deterministic = det
                engine = ex.build_engine(ex.parse_args(argv))
                engine.config.block_periods = 1
                tag = f"[checkpoint mwn] {label} (cudnn.deterministic {det})"
                if label in ("cut", "resumed"):
                    engine.config.checkpoint_dir, engine.config.checkpoint_step = path, cut
                    engine.config.auto_resume = label == "resumed"
                    engine.train_iters = cut if label == "cut" else periods
                    engine.run()
                    torch.cuda.synchronize()
                else:
                    seconds, report, peak = _timed_run(engine, 1, periods, tag, _op_class,
                                                       profiled="card")
                    out[label] = _cell_line(tag, seconds, report, peak, warmup)
                assert engine.classifier.count == (cut if label == "cut" else periods)
                losses[label] = _fixed_losses(engine)
                finals[label] = {n: {k: t.cpu() for k, t in s["params"].items()}
                                 for n, s in engine.states.items()}
                del engine
                _free()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    resumed_err = _state_err(finals["deterministic"], finals["resumed"])
    default_err = _state_err(finals["deterministic"], finals["default"])
    loss_diff = {n: abs(losses["deterministic"][n] - losses["resumed"][n])
                 for n in losses["resumed"]}
    det, dflt = out["deterministic"], out["default"]
    log(f"[checkpoint mwn] fixed-batch losses uninterrupted {losses['deterministic']}, resumed "
        f"{losses['resumed']} (|diff| {loss_diff}), default cuDNN {losses['default']}; max "
        f"|param diff| resumed {resumed_err:.3e}, default vs deterministic {default_err:.3e}")
    log(f"[checkpoint mwn] what cudnn.deterministic costs the compiled period: median "
        f"{det['median']:.6f} s against {dflt['median']:.6f} s ({det['median'] / dflt['median']:.3f}x), "
        f"busy {det['busy_ms']:.2f} ms against {dflt['busy_ms']:.2f} ms")
    assert all(math.isfinite(v) for ls in losses.values() for v in ls.values()), losses
    assert all(d == 0.0 for d in loss_diff.values()), loss_diff
    out.update(resumed_err=resumed_err, default_err=default_err, losses=losses)
    return out


def checkpoint_phase():
    t0 = time.time()
    for variant, unroll in CKPT_SMALL:
        for compiled in (False, True):
            checkpoint_small_phase(variant, unroll, compiled)
    sama_checkpoint_cell()
    mwn_checkpoint_cell()
    log(f"[checkpoint] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# remat: activation rematerialization of the encoder blocks
# (models/transformer.py) on the RoBERTa-large paths
# ---------------------------------------------------------------------------

REMAT_POLICIES = {"off": [], "full": ["--remat"],
                  "minimal": ["--remat", "--remat_policy", "minimal"]}
DEPTH, FORWARDS, BACKWARDS = 24, 9, 6  # encoder blocks; encoder passes a SAMA period


def remat_expected(policy):
    """Launches of B3/B4/B5 a SAMA period at S1024: one B3 a block of every
    forward, one B4 and one B5 a block of every backward; under "minimal"
    each block's backward replays its forward, B3 included."""
    b3 = DEPTH * (FORWARDS + (BACKWARDS if policy == "minimal" else 0))
    return {"flash_single_fwd": 0, "flash_single_bwd": 0, "flash_multi_fwd": b3,
            "flash_multi_bwd_dkv": DEPTH * BACKWARDS, "flash_multi_bwd_dq": DEPTH * BACKWARDS}


def _peak_split(engine):
    """Record the peak of device memory inside the classifier's optimizer
    steps (``step``) and elsewhere (``rest``: the forward and backward
    passes and the reweight step), in GiB, by resetting the peak counter
    around each step; the run's overall peak is the larger of the two and
    what the counter reads at its end."""
    import torch

    rec = {"step": 0.0, "rest": 0.0}
    problem = engine.classifier
    orig = problem._apply_optimizer

    def step(*args, **kwargs):
        rec["rest"] = max(rec["rest"], torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        out = orig(*args, **kwargs)
        rec["step"] = max(rec["step"], torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        return out

    problem._apply_optimizer = step
    return rec


def remat_long_cell(periods=3):
    """SAMA ``--flash`` at B8 S1024 in driver mode with remat off, "full"
    (the flash residuals kept) and "minimal" (everything replayed):
    ``periods`` meta-periods (the first warm-up, the last profiled), the
    period, peak memory, the launches of B3-B5 a period (exact), and the
    parameters against remat off after the same periods."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    argv = SAMA_S128_ARGV + ["--flash", "--seq_len", "1024", "--batch_size", "8"]
    out, finals = {}, {}
    for policy, flags in REMAT_POLICIES.items():
        tag = f"[remat S1024] {policy}"
        engine = ex.build_engine(ex.parse_args(argv + flags))
        reset, counters = _counters("sama")
        split = _peak_split(engine)
        reset()
        seconds, report, peak = _timed_run(engine, 5, periods, tag, profiled="card")
        peak = max(peak, *split.values())
        launches = {k: c.launches for k, c in counters.items()}
        per_period = {k: v // periods for k, v in launches.items()}
        out[policy] = _cell_line(tag, seconds, report, peak, 1)
        out[policy].update(launches=per_period, peak_split=split)
        log(f"{tag} launches a period {per_period} (expected {remat_expected(policy)}); peak "
            f"{peak:.3f} GiB: {split['step']:.3f} inside the classifier's optimizer steps, "
            f"{split['rest']:.3f} elsewhere (forward and backward passes, the reweight step)")
        assert launches == {k: v * periods for k, v in remat_expected(policy).items()}, launches
        assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
                   for t in s["params"].values())
        finals[policy] = {n: {k: t.cpu() for k, t in s["params"].items()}
                          for n, s in engine.states.items()}
        del engine
        _free()
    for policy in ("full", "minimal"):
        out[policy]["param_diff"] = _state_err(finals["off"], finals[policy])
    log(f"[remat S1024] max |param diff| against remat off after {periods} periods: full "
        f"{out['full']['param_diff']:.3e}, minimal {out['minimal']['param_diff']:.3e} "
        "(bit for bit expected)")
    return out


def remat_s128_cell(periods=3):
    """S128 SAMA ``--flash --remat`` ("full": the flash residuals kept),
    driver mode then compiled, ``periods`` meta-periods each (the first
    warm-up or capture, the last profiled): period, peak, launches, and the
    parameters of the two modes; then "dots" on the plain attention (no
    ``--flash``): ``2`` periods and peak."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    out, finals = {}, {}
    for mode in ("driver", "compiled"):
        tag = f"[remat S128] full {mode}"
        engine = ex.build_engine(ex.parse_args(
            SAMA_S128_ARGV + ["--flash", "--remat"] + (["--compile_blocks"]
                                                      if mode == "compiled" else [])))
        engine.config.block_periods = 1
        reset, counters = _counters("sama")
        with _CaptureWatch(counters) as watch:
            reset()
            seconds, report, peak = _timed_run(engine, 5, periods, tag,
                                               profiled="all" if mode == "compiled" else None)
        launches = {k: c.launches for k, c in counters.items()}
        out[mode] = _cell_line(tag, seconds, report, peak, 1)
        per_period = watch.per_replay if mode == "compiled" else \
            {k: v // periods for k, v in launches.items()}
        log(f"{tag} launches a period {per_period}"
            + (f"; captures {engine.block_runner.captures}, capture "
               f"{engine.block_runner.capture_seconds:.2f} s" if mode == "compiled" else ""))
        assert per_period == {k: v // 2 for k, v in SAMA_S128.items()}, per_period
        finals[mode] = {n: {k: t.cpu() for k, t in s["params"].items()}
                        for n, s in engine.states.items()}
        del engine
        _free()
    out["param_diff"] = _state_err(finals["driver"], finals["compiled"])
    log(f"[remat S128] compiled vs driver after {periods} periods: max |param diff| "
        f"{out['param_diff']:.3e}")
    tag = "[remat S128] dots, plain attention"
    engine = ex.build_engine(ex.parse_args(SAMA_S128_ARGV + ["--remat", "--remat_policy",
                                                             "dots"]))
    seconds, report, peak = _timed_run(engine, 5, 2, tag, profiled=None)
    out["dots"] = {"seconds": seconds, "peak_gib": peak}
    log(f"{tag}: s/meta-period {seconds} (the first includes warm-up); peak {peak:.3f} GiB")
    assert all(bool(torch.isfinite(t).all()) for s in engine.states.values()
               for t in s["params"].values())
    del engine
    _free()
    return out


def remat_phase():
    t0 = time.time()
    remat_long_cell()
    remat_s128_cell()
    log(f"[remat] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# nas: DARTS neural architecture search (examples/neural_architecture_search.py)
# and its evaluation phase (examples/nas_eval.py), which run no kernel of the
# port: cuDNN convolutions (depthwise, dilated, pointwise), pools and BatchNorm
# ---------------------------------------------------------------------------

NAS_SMALL_SEARCH = ["--channels", "4", "--layers", "3", "--batch_size", "8", "--train_size",
                    "32", "--valid_step", "1000"]
NAS_SMALL_EVAL = ["--init_channels", "4", "--layers", "4", "--batch_size", "8", "--train_size",
                  "32", "--epochs", "1", "--auxiliary", "--cutout", "--drop_path_prob", "0.0",
                  "--valid_every_epochs", "100"]
NAS_PERIODS = 3  # cut from 4 for the time limit
NAS_SEARCH_LEAVES = 1_401  # 1,399 of the supernet at C16 L8 and the two alphas
NAS_SEARCH_BATCHNORMS = 929


def _port_launches():
    """Launches of B1-B8 since their counters were last reset."""
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    return {**{k: f.launches for k, f in fa.KERNELS.items()},
            **{k: getattr(vec, k).launches for k in VECTOR_KERNELS}}


def _reset_port_launches():
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    fa.reset_launch_counts()
    vec.reset_launch_counts()


def _nas_engine(example, argv, device, compiled, states=None, dtype=None):
    """A NAS example's engine (the DARTS search and evaluation phase, robust
    NAS, SANAS) on ``device``; ``states`` (CPU tensors) replace its own and
    ``dtype`` casts states and inputs."""
    import numpy as np
    import torch
    from betty_tpu_torch.utils import tree_map

    engine = example.build_engine(example.parse_args(
        argv + ["--device", device] + (["--compile_blocks"] if compiled else [])))
    engine.config.block_periods = 1
    if states is not None:
        engine.states = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, states)
    if dtype is not None:
        engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and
                                 t.is_floating_point() else t, engine.states)
        name = str(dtype).split(".")[1]
        for prob in engine.problems:
            for loader in prob.train_data_loader:
                if isinstance(loader, list):  # host batches (SANAS)
                    loader[:] = [(np.asarray(x, name), y) for x, y in loader]
                else:
                    loader.arrays = (np.asarray(loader.arrays[0], name), *loader.arrays[1:])
    return engine


def nas_small_phase(which, card):
    """The small float64 search (C4 L3 B8, ``NAS_PERIODS`` meta-periods,
    roll-back) or evaluation phase (DARTS_V2 C4 L4 B8, auxiliary head,
    cutout, drop-path 0, grad clip 5, 4 steps) on the card against the CPU
    from the same weights, within 1e-9; then compiled blocks against driver
    mode on the card, bit for bit. cuDNN runs its deterministic
    algorithms."""
    import torch
    from betty_tpu_torch.examples import nas_eval, neural_architecture_search

    example, argv = {"search": (neural_architecture_search, NAS_SMALL_SEARCH),
                     "eval": (nas_eval, NAS_SMALL_EVAL)}[which]
    argv = argv + (["--train_iters", str(NAS_PERIODS)] if which == "search" else [])
    tag = f"[nas small] {which} [{card}]"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = _nas_engine(example, argv, "cpu", False, dtype=torch.float64).states
        runs = {}
        for label, device, compiled in (("cpu", "cpu", False), ("card", "cuda", False),
                                        ("compiled", "cuda", True)):
            engine = _nas_engine(example, argv, device, compiled, states, torch.float64)
            if which == "eval":
                engine.train_iters = NAS_PERIODS
            engine.run()
            runs[label] = engine
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card_err = _mwn_tree_err(runs["cpu"].states, runs["card"].states)
    comp_err = _state_err(runs["card"].states, runs["compiled"].states)
    moved = _mwn_tree_err(states, runs["card"].states)
    runner = runs["compiled"].block_runner
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    finite = all(bool(torch.isfinite(t).all()) for e in runs.values() for s in e.states.values()
                 for t in s["params"].values())
    log(f"{tag}: card vs CPU max |param or batch_stats diff| {card_err:.3e} (tol 1e-9; moved "
        f"{moved:.3e}); compiled vs driver on the card max |state diff| {comp_err:.3e} (bit for "
        f"bit); captures {runner.captures}, replays {runner.replays} of {runner.periods_run} "
        f"periods, capture {runner.capture_seconds:.2f} s; counts {counts}; finite {finite}")
    assert all(c == [NAS_PERIODS] * len(c) for c in counts.values()), counts
    assert finite and moved > 0 and card_err <= 1e-9 and comp_err == 0.0, (card_err, comp_err)
    assert runner.captures == 1 and runner.replays == runner.periods_run >= NAS_PERIODS - 1
    if which == "search":
        from betty_tpu_torch.models.darts import derive_genotype

        genotypes = [derive_genotype(e.arch.params) for e in runs.values()]
        log(f"{tag}: genotype {genotypes[0]}; the same in all three runs "
            f"{all(g == genotypes[0] for g in genotypes)}")
        assert all(g == genotypes[0] for g in genotypes)
    del runs, runner
    _free()
    return card_err, comp_err


def _nas_counts(engine):
    """Parameter leaves, BatchNorms (two running statistics each) and
    parameters of an engine's states."""
    leaves = sum(len(s["params"]) for s in engine.states.values())
    stats = sum(len(s["extra"].get("batch_stats", {})) for s in engine.states.values())
    n_params = sum(t.numel() for s in engine.states.values() for t in s["params"].values())
    return leaves, stats // 2, n_params


def _nas_eval_loss(engine):
    """The evaluation network's training loss at its parameters on a fixed
    batch (the first 96 images, drop-path 0), no graph."""
    import torch

    ld = engine.network.train_data_loader[0]
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    batch = (torch.as_tensor(ld.arrays[0][:ld.batch_size]).cuda(),
             torch.as_tensor(ld.arrays[1][:ld.batch_size]).cuda(), torch.zeros((), device="cuda"))
    with torch.no_grad():
        return float(engine.network.eval_loss(ctx, batch)[0])


def nas_search_cell(card, warmup=1, steady=1):
    """The DARTS search at its published width (C16 L8 B64, float32, TF32
    off; SGD 0.025 momentum 0.9 with cosine LR, Adam 3e-4 on the alphas,
    unroll 1, roll-back; synthetic CIFAR in the default host loaders),
    driver mode then compiled blocks (one replay a period): ``warmup`` +
    ``steady`` timed periods and one profiled each. The fixed-batch losses
    after each warm-up period are compared between the modes (float32 cuDNN
    does not repeat bit for bit); both must derive a genotype of 8 + 8
    edges."""
    import torch
    from betty_tpu_torch.examples import neural_architecture_search as ex
    from betty_tpu_torch.models.darts import derive_genotype

    periods = warmup + steady + 1
    argv = ["--train_iters", str(periods), "--valid_step", "1000000",
            "--train_size", "2048"]
    out, losses = {}, {}
    for mode in ("driver", "compiled"):
        tag = f"[nas search] C16 L8 B64 {mode} [{card}]"
        t0 = time.time()
        engine = _nas_engine(ex, argv, "cuda", mode == "compiled")
        leaves, bns, n_params = _nas_counts(engine)
        log(f"{tag} build_engine {time.time() - t0:.1f} s; parameter leaves {leaves} (the "
            f"supernet's and the alphas), BatchNorms {bns}, parameters {n_params}")
        assert leaves == NAS_SEARCH_LEAVES and bns == NAS_SEARCH_BATCHNORMS, (leaves, bns)
        seen = losses[mode] = []
        validate = engine.maybe_validate_checkpoint

        def hook(window=1, _engine=engine, _seen=seen, _validate=validate):
            stop = _validate(window)
            if len(_seen) < warmup:
                _seen.append(_fixed_losses(_engine))
            return stop

        engine.maybe_validate_checkpoint = hook
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, 1, periods, tag, _op_class, profiled="card")
        ours = _port_launches()
        out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        if report:
            shares = {k: round(v / report["busy_ms"], 3) for k, v in report["by_kind"].items()}
            out[mode]["shares"] = shares
            log(f"{tag} device time shares {shares}")
        if mode == "compiled":
            r = engine.block_runner
            out[mode]["capture_s"] = r.capture_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}, capture (two warm-up "
                f"periods and the capture) {r.capture_seconds:.3f} s; kernels in the profiled "
                f"replay (the graph's nodes) {report['launches'] if report else 'not read'}")
            assert r.captures == 1 and r.replays == periods
        genotype = derive_genotype(engine.arch.params)
        final = _fixed_losses(engine)
        log(f"{tag} fixed-batch losses after periods 1..{warmup} {seen}, after {periods} "
            f"{final}; genotype {genotype}; launches of the port's kernels {ours}")
        assert len(genotype.normal) == len(genotype.reduce) == 8
        assert engine.classifier.count == engine.arch.count == periods
        assert all(math.isfinite(v) for d in seen + [final] for v in d.values())
        assert all(n == 0 for n in ours.values()), ours
        del engine
        _free()
    diffs = [max(abs(a[k] - b[k]) / abs(b[k]) for k in a)
             for a, b in zip(losses["driver"], losses["compiled"])]
    log(f"[nas search] [{card}] compiled vs driver: relative difference of the fixed-batch "
        f"losses after periods 1..{warmup}: {diffs} (tol 1e-3: float32 cuDNN is not "
        "repeatable)")
    assert max(diffs) <= 1e-3, diffs
    return out


def nas_eval_cell(card, warmup=1, steady=1):
    """The evaluation phase at DARTS's CIFAR-10 settings (DARTS_V2, C36
    L20 B96, auxiliary head 0.4, drop-path 0.2, cutout 16, grad clip 5,
    float32, TF32 off): driver mode, then compiled blocks (one replay a
    step): ``warmup`` + ``steady`` timed steps and one profiled each."""
    import torch
    from betty_tpu_torch.examples import nas_eval as ex

    steps = warmup + steady + 1
    argv = ["--auxiliary", "--cutout", "--train_size", str(96 * steps), "--epochs", "1",
            "--valid_every_epochs", "100"]
    out = {}
    for mode in ("driver", "compiled"):
        tag = f"[nas eval] DARTS_V2 C36 L20 B96 {mode} [{card}]"
        engine = _nas_engine(ex, argv, "cuda", mode == "compiled")
        # drop-path at its full 0.2: the loader's epoch past the ramp
        engine.network.train_data_loader[0].set_epoch(1)
        leaves, bns, n_params = _nas_counts(engine)
        log(f"{tag}: parameter leaves {leaves}, BatchNorms {bns}, parameters {n_params}")
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, 1, steps, tag, _op_class, profiled="card")
        out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        if mode == "compiled":
            r = engine.block_runner
            out[mode]["capture_s"] = r.capture_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}, capture "
                f"{r.capture_seconds:.3f} s")
            assert r.captures == 1 and r.replays == steps
        ours = _port_launches()
        loss = _nas_eval_loss(engine)
        dp = float(engine.network.cur_batch[2])
        log(f"{tag} fixed-batch loss {loss}; drop-path probability of the last batch {dp}; "
            f"launches of the port's kernels {ours}")
        assert engine.network.count == steps and math.isfinite(loss) and abs(dp - 0.2) < 1e-7
        assert all(n == 0 for n in ours.values()), ours
        assert all(bool(torch.isfinite(t).all())
                   for t in engine.states["network"]["params"].values())
        del engine
        _free()
    return out


def nas_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    for which in ("search", "eval"):
        nas_small_phase(which, card)
    nas_search_cell(card)
    nas_eval_cell(card)
    log(f"[nas] [{card}] phase done in {time.time() - t0:.1f} s")



# ---------------------------------------------------------------------------
# robust: robust NAS (examples/robust_nas.py: the DARTS search whose
# classifier loss adds the input-Jacobian and CURE terms, a second-order
# pass through the inputs) and the 4-level saliency-aware NAS
# (examples/saliency_aware_nas_4_level.py: three problems, three
# hypergradient paths, a PGD attack inside a step); no kernel of the port
# runs on either (cuDNN and PyTorch ops)
# ---------------------------------------------------------------------------

ROBUST_SMALL = {"darts": ["--channels", "2", "--layers", "1"], "mlp": ["--arch", "mlp"]}
ROBUST_SMALL_ARGV = ["--batch_size", "4", "--train_size", "16", "--valid_step", "1000"]
ROBUST_PERIODS = 2
SANAS_SMALL = ["--dim", "16", "--classes", "3", "--n", "256", "--batch", "32",
               "--valid_step", "1000", "--train_iters", "16"]  # 4 outer steps


def _host_directions(rng, x):
    """The Jacobian term's direction drawn on the host from the step's seed,
    the same on every device (the example's own generator draws differently
    on the CPU and on the card)."""
    import numpy as np
    import torch
    from betty_tpu_torch.examples.robust_nas import DIRECTION_FOLD
    from betty_tpu_torch.utils import fold_in

    r = np.random.RandomState(fold_in(rng, DIRECTION_FOLD) % 2**32)
    return torch.from_numpy(r.standard_normal(tuple(x.shape))).to(x.device, x.dtype)


def robust_small_phase(which, card):
    """Small float64 runs, cuDNN deterministic: the robust search (C2 L1 B4
    on the ``darts`` backbone or the ``mlp`` one, both regularizers,
    ``ROBUST_PERIODS`` meta-periods) or SANAS (dim 16, 3 classes, 4 outer
    steps) on the card against the CPU from the same weights within 1e-9
    (the Jacobian directions drawn on the host on both sides), then
    compiled blocks against driver mode on the card bit for bit (the
    directions from the example's own generator, in the graph's reseeded
    pool: fresh every replay)."""
    import torch
    from betty_tpu_torch.examples import robust_nas, saliency_aware_nas_4_level

    if which == "sanas":
        example, argv = saliency_aware_nas_4_level, SANAS_SMALL
    else:
        example = robust_nas
        argv = (ROBUST_SMALL_ARGV + ROBUST_SMALL[which] +
                ["--train_iters", str(ROBUST_PERIODS)])
    tag = f"[robust small] {which} [{card}]"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _reset_port_launches()
    runs = {}
    try:
        states = _nas_engine(example, argv, "cpu", False, dtype=torch.float64).states
        for label, device, compiled, host in (("cpu", "cpu", False, True),
                                              ("card", "cuda", False, True),
                                              ("driver", "cuda", False, False),
                                              ("compiled", "cuda", True, False)):
            if which == "sanas" and label == "driver":
                runs["driver"] = runs["card"]  # no random draws
                continue
            engine = _nas_engine(example, argv, device, compiled, states, torch.float64)
            if host and which != "sanas":
                engine.classifier.directions = _host_directions
            with _CaptureWatch({}) as watch:
                engine.run()
            runs[label] = engine
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card_err = _mwn_tree_err(runs["cpu"].states, runs["card"].states)
    comp_err = _state_err(runs["driver"].states, runs["compiled"].states)
    moved = _mwn_tree_err(states, runs["card"].states)
    runner = runs["compiled"].block_runner
    seeds = [w[2] for w in watch.written]
    fresh = all(a != b for r in range(len(seeds) - 1) for a, b in zip(seeds[r], seeds[r + 1]))
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    finite = all(bool(torch.isfinite(t).all()) for e in runs.values() for s in e.states.values()
                 for t in s["params"].values())
    ours = _port_launches()
    log(f"{tag}: card vs CPU max |param or batch_stats diff| {card_err:.3e} (tol 1e-9; moved "
        f"{moved:.3e}); compiled vs driver on the card max |state diff| {comp_err:.3e} (bit for "
        f"bit); captures {runner.captures}, replays {runner.replays} of {runner.periods_run} "
        f"periods, capture {runner.capture_seconds:.2f} s; generators a period "
        f"{len(seeds[0]) if seeds else 0}, fresh seeds every replay {fresh}; counts {counts}; "
        f"finite {finite}; launches of B1-B8 {ours}")
    if which == "sanas":
        want = [4, 8, 16]
        paths = [[q.name for q in path] for path in runs["card"].outer.paths]
        log(f"{tag}: the outer problem's paths {paths}")
        assert len(paths) == 3, paths
    else:
        want = [ROBUST_PERIODS, ROBUST_PERIODS]
        # the Jacobian direction of the classifier's step and of darts' two
        # evaluations
        assert seeds and len(seeds[0]) == 3 and fresh, seeds
    assert all(c == want for c in counts.values()), counts
    assert finite and moved > 0 and card_err <= 1e-9 and comp_err == 0.0, (card_err, comp_err)
    assert runner.captures == 1 and runner.replays == runner.periods_run >= 1
    assert all(n == 0 for n in ours.values()), ours
    del runs, runner
    _free()
    return card_err, comp_err


class _ConvCount:
    """Counts the convolutions of a run at the dispatcher (a
    ``TorchDispatchMode``, which the autograd engine's device threads
    inherit): all of them, their backwards, and the per-group ones of
    PyTorch's conv double backward, which computes a grouped convolution's
    weight term one group at a time: a convolution with ``groups=1`` and a
    one-channel "weight" (the output gradient of one group, batch as its
    channels). No convolution of the supernet itself has one output
    channel."""

    def __init__(self):
        self.total = self.per_group = self.backward = 0

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                if name.startswith("aten.convolution."):
                    counter.total += 1
                    if args[8] == 1 and args[1].shape[0] == 1:
                        counter.per_group += 1
                elif name.startswith("aten.convolution_backward."):
                    counter.backward += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


def grouped_convolutions(channels=16, layers=8):
    """``(grouped convolutions of the C16 L8 supernet, the sum of their
    groups)``: the second is the per-group convolutions of one double
    backward through all of them."""
    from betty_tpu_torch.models.darts import DARTSNetwork
    from betty_tpu_torch.models.layers import Conv

    convs = [m for m in DARTSNetwork(channels=channels, layers=layers).modules()
             if isinstance(m, Conv) and m.groups > 1]
    return len(convs), sum(m.groups for m in convs)


ROBUST_SEARCH_LAYERS = 3  # depth cut from DARTS's 8 cells so the whole script keeps its time
ROBUST_SEARCH_LEAVES = 550  # 548 of the supernet at C16 L3 and the two alphas
ROBUST_SEARCH_BATCHNORMS = 359


def robust_full_cell(card, warmup=1, steady=1):
    """The robust search at the DARTS search widths, depth cut to
    ``ROBUST_SEARCH_LAYERS`` cells (C16 L3 B32: a normal cell and two
    reduction cells; both regularizers, lambda_j 0.1, lambda_c 0.01; SGD
    0.025 momentum 0.9, no schedule, no roll-back; Adam 3e-4 on the alphas;
    float32, TF32 off;
    synthetic CIFAR in the host loaders), driver mode then compiled blocks
    (one replay a period): ``warmup`` + ``steady`` timed periods and one
    profiled each (period, busy, idle, launches, device time by op class,
    convolution time by kernel, peak memory; capture split into the warm-up
    periods and the recording), then one driver period counting its
    convolutions (``_ConvCount``: no per-group one, since the grouped
    convolutions run through ``models/layers.py::grouped_conv2d``). The fixed-batch losses after each
    warm-up period agree between the modes within 1e-3 relative; B1-B8
    launch 0 times."""
    import torch
    from betty_tpu_torch.examples import robust_nas as ex
    from betty_tpu_torch.models.darts import derive_genotype

    layers = ROBUST_SEARCH_LAYERS
    periods = warmup + steady + 1
    argv = ["--layers", str(layers), "--train_iters", str(periods), "--valid_step", "1000000"]
    out, losses = {}, {}
    for mode in ("driver", "compiled"):
        tag = f"[robust search] C16 L{layers} B32 {mode} [{card}]"
        t0 = time.time()
        engine = _nas_engine(ex, argv, "cuda", mode == "compiled")
        leaves, bns, n_params = _nas_counts(engine)
        log(f"{tag} build_engine {time.time() - t0:.1f} s; parameter leaves {leaves}, "
            f"BatchNorms {bns}, parameters {n_params}; lambda_j "
            f"{engine.classifier.cfg['lambda_j']}, lambda_c {engine.classifier.cfg['lambda_c']}")
        assert leaves == ROBUST_SEARCH_LEAVES and bns == ROBUST_SEARCH_BATCHNORMS, (leaves, bns)
        seen = losses[mode] = []
        validate = engine.maybe_validate_checkpoint

        def hook(window=1, _engine=engine, _seen=seen, _validate=validate):
            stop = _validate(window)
            if len(_seen) < warmup:
                _seen.append(_fixed_losses(_engine))
            return stop

        engine.maybe_validate_checkpoint = hook
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, 1, periods, tag, _op_class, profiled="card")
        row = out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        if report:
            row["launches"] = report["launches"]
            row["shares"] = {k: round(v / report["busy_ms"], 3)
                             for k, v in report["by_kind"].items()}
            convs = sorted((k for k in report["kernels"] if _op_class(k[2]) == "convolution"),
                           reverse=True)
            row["conv_ms"] = sum(t for t, _, _ in convs)
            log(f"{tag} device time shares {row['shares']}; convolution {row['conv_ms']:.1f} ms "
                f"over {sum(c for _, c, _ in convs)} launches, by kernel:")
            for t, c, name in convs[:12]:
                log(f"{tag}   {t:9.2f} ms  x{c:<7d} {t * 1e3 / c:8.1f} us/launch  {name[:100]}")
        if mode == "compiled":
            r = engine.block_runner
            row["capture_s"], row["warmup_s"] = r.capture_seconds, r.warmup_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}; capture "
                f"{r.capture_seconds:.3f} s: two warm-up periods {r.warmup_seconds:.3f} s, "
                f"recording {r.capture_seconds - r.warmup_seconds:.3f} s; graph nodes (kernels "
                f"of the profiled replay) {report['launches'] if report else 'not read'}")
            assert r.captures == 1 and r.replays == periods
        else:
            engine.train_iters = 1
            engine.maybe_validate_checkpoint = validate
            with _ConvCount() as cc:
                engine.run()
            torch.cuda.synchronize()
            row.update(conv_calls=cc.total, per_group_convs=cc.per_group,
                       conv_backwards=cc.backward)
            n_grouped, slices = grouped_convolutions(layers=layers)
            log(f"{tag} one more driver period at the dispatcher: {cc.total} convolutions, "
                f"{cc.per_group} per-group convolutions of PyTorch's conv double backward (the "
                f"supernet's {n_grouped} grouped convolutions hold {slices} groups; "
                f"models/layers.py::grouped_conv2d takes their weight term whole), "
                f"{cc.backward} convolution backwards")
            assert cc.per_group == 0, cc.per_group
        genotype = derive_genotype(engine.arch.params)
        final = _fixed_losses(engine)
        ours = _port_launches()
        log(f"{tag} fixed-batch losses after periods 1..{warmup} {seen}, at the end {final}; "
            f"genotype {genotype}; launches of B1-B8 {ours}")
        assert len(genotype.normal) == len(genotype.reduce) == 8
        assert all(math.isfinite(v) for d in seen + [final] for v in d.values())
        assert all(n == 0 for n in ours.values()), ours
        del engine
        _free()
    diffs = [max(abs(a[k] - b[k]) / abs(b[k]) for k in a)
             for a, b in zip(losses["driver"], losses["compiled"])]
    log(f"[robust search] [{card}] compiled vs driver: relative difference of the fixed-batch "
        f"losses after periods 1..{warmup}: {diffs} (tol 1e-3: float32 cuDNN is not "
        "repeatable)")
    assert max(diffs) <= 1e-3, diffs
    return out


def sanas_cell(card, periods=10):
    """SANAS at the JAX example's defaults (dim 32, 5 classes, n 512, batch
    64, MLP [64, 5], 3 PGD steps, unroll 2 and 2) in driver mode for
    ``periods`` outer periods: finite losses of all three problems, the
    outer problem's three paths, counts 8:4:2 per 8 inner1 steps; the
    seconds of each outer period."""
    import torch
    from betty_tpu_torch.examples import saliency_aware_nas_4_level as ex

    tag = f"[sanas] defaults, driver [{card}]"
    engine = ex.build_engine(ex.parse_args(["--device", "cuda", "--train_iters",
                                            str(4 * periods), "--valid_step", "1000000"]))
    losses, ends = {p.name: [] for p in engine.problems}, []
    for p in engine.problems:
        def record(*a, _p=p, _orig=p.one_step_descent, **kw):
            out = _orig(*a, **kw)
            losses[_p.name].append(float(out["loss"]))
            if _p.name == "outer":
                torch.cuda.synchronize()
                ends.append(time.time())
            return out

        p.one_step_descent = record
    _reset_port_launches()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    seconds = [b - a for a, b in zip([t0] + ends, ends)]
    q1, med, q3 = _quartiles(seconds[3:])
    counts = [p.count for p in engine.problems]
    paths = [[q.name for q in path] for path in engine.outer.paths]
    stats = engine.validation()
    ours = _port_launches()
    finite = all(math.isfinite(v) for ls in losses.values() for v in ls)
    log(f"{tag}: {periods} outer periods; s/outer period median {med:.6f} quartiles {q1:.6f} / "
        f"{q3:.6f} (periods 4..{periods}); counts {counts}; paths {paths}; losses (last) "
        f"{ {k: v[-1] for k, v in losses.items()} }; finite {finite}; validation {stats}; "
        f"launches of B1-B8 {ours}")
    assert counts == [periods, 2 * periods, 4 * periods] and len(paths) == 3, (counts, paths)
    assert finite and all(n == 0 for n in ours.values()), ours
    del engine
    _free()
    return {"median": med, "q1": q1, "q3": q3}


def robust_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    for which in ("mlp", "darts", "sanas"):
        robust_small_phase(which, card)
    robust_full_cell(card)
    sanas_cell(card)
    log(f"[robust] [{card}] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# programs: the 3-level image-captioning NAS (IUC), learning by ignoring
# (LBI, per-group optimizers) and implicit MAML (an env-fed program on the
# Omniglot CNN), none of which launches a kernel of the port
# ---------------------------------------------------------------------------

PROGRAMS_SMALL = {  # name: (argv, compiled run too)
    "iuc": (["--n", "64", "--batch", "8", "--seq_len", "6", "--vocab", "16", "--feat_dim", "8",
             "--dim", "16", "--depth", "1", "--heads", "2", "--valid_step", "1000000",
             "--train_iters", "16"], True),  # 4 outer periods
    "lbi": (["--dim", "16", "--classes", "3", "--n_source", "128", "--n_target", "128",
             "--batch", "32", "--features_lr", "0.08", "--classifier_lr", "0.02",
             "--train_iters", "8"], True),
    "imaml": (["--ways", "3", "--inner_steps", "2", "--meta_batch_size", "2",
               "--train_iters", "8"], False),  # 2 meta updates
}
LBI_GROUPS = ["--features_lr", "0.08", "--classifier_lr", "0.02"]


def _program_example(name):
    from betty_tpu_torch.examples import implicit_maml, learning_by_ignoring
    from betty_tpu_torch.examples import nas_augmented_image_captioning_3_level as iuc

    return {"iuc": iuc, "lbi": learning_by_ignoring, "imaml": implicit_maml}[name]


def _program_engine(name, argv, device, compiled, states=None, dtype=None):
    """A program's engine on ``device``; ``states`` (CPU tensors) replace
    its own and ``dtype`` casts the states, the loaders' features and the
    env's tasks."""
    import numpy as np
    import torch
    from betty_tpu_torch.utils import tree_map

    example = _program_example(name)
    engine = example.build_engine(example.parse_args(
        argv + ["--device", device] + (["--compile_blocks"] if compiled else [])))
    engine.config.block_periods = 1
    if states is not None:
        engine.states = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, states)
    if dtype is None:
        return engine
    engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and
                             t.is_floating_point() else t, engine.states)
    np_dtype = str(dtype).split(".")[1]

    def cast(batch):
        return (np.asarray(batch[0], np_dtype), *batch[1:])

    for prob in engine.problems:
        for loader in prob.train_data_loader or ():
            loader[:] = [cast(b) for b in loader]
    env = engine.env
    if env is not None:
        step = env.step

        def cast_step():
            step()
            env.support, env.query = cast(env.support), cast(env.query)

        env.support, env.query = cast(env.support), cast(env.query)
        env.step = cast_step
    return engine


def _rel_err(a_states, b_states):
    """Largest |difference| of two engines' parameters (and of each dict of
    tensors in ``extra``: running statistics, an EMA teacher), relative to
    the largest |value| of that problem's parameters (statistics, teacher).
    Not leaf by leaf: an attention key bias, whose true gradient is 0, holds
    rounding noise of 1e-17 alone (ROADMAP §C)."""
    err = 0.0
    for name, a in a_states.items():
        b = b_states[name]
        assert set(a["extra"]) == set(b["extra"]), name
        pairs = [(a["params"], b["params"])] + [(v, b["extra"][k]) for k, v in a["extra"].items()
                                                 if isinstance(v, dict)]
        for ta, tb in pairs:
            assert set(ta) == set(tb), name
            if not ta:
                continue
            scale = max(float(y.abs().max()) for y in tb.values()) or 1.0
            diff = max(float((x.double().cpu() - tb[k].double().cpu()).abs().max())
                       for k, x in ta.items())
            err = max(err, diff / scale)
    return err


def program_small_phase(name, card):
    """A program at a small size in float64 (cuDNN deterministic) on the card
    against the CPU from the same weights, within 1e-9 relative on every
    problem's parameters; IUC and LBI also compiled against driver mode on
    the card, bit for bit. B1-B8 launch 0 times."""
    import torch

    argv, with_compiled = PROGRAMS_SMALL[name]
    tag = f"[programs small] {name} [{card}]"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _reset_port_launches()
    runs = {}
    t0 = time.time()
    try:
        states = _program_engine(name, argv, "cpu", False, dtype=torch.float64).states
        for label, device, compiled in (("cpu", "cpu", False), ("card", "cuda", False),
                                        ("compiled", "cuda", True)):
            if compiled and not with_compiled:
                continue
            engine = _program_engine(name, argv, device, compiled, states, torch.float64)
            engine.run()
            runs[label] = engine
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card_err = _rel_err(runs["cpu"].states, runs["card"].states)
    moved = _rel_err(states, runs["card"].states)
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    ours = _port_launches()
    line = (f"{tag}: card vs CPU max relative |param or statistic diff| {card_err:.3e} (tol "
            f"1e-9; moved {moved:.3e}); counts {counts}")
    comp_err = None
    if with_compiled:
        comp_err = _state_err(runs["card"].states, runs["compiled"].states)
        runner = runs["compiled"].block_runner
        line += (f"; compiled vs driver on the card max |state diff| {comp_err:.3e} (bit for "
                 f"bit), captures {runner.captures}, replays {runner.replays} of "
                 f"{runner.periods_run} periods")
        assert comp_err == 0.0 and runner.captures == 1 and runner.replays >= 1, comp_err
    log(f"{line}; launches of B1-B8 {ours}; {time.time() - t0:.1f} s")
    assert len({tuple(c) for c in counts.values()}) == 1, counts
    assert moved > 0 and card_err <= 1e-9, (card_err, moved)
    assert all(n == 0 for n in ours.values()), ours
    del runs
    _free()
    return card_err, comp_err


def _list_fixed_losses(engine):
    """Every problem's loss at the engine's parameters on the first batch of
    its loader (the env's current task where it has none), no graph."""
    import torch

    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    out = {}
    with torch.no_grad():
        for p in engine.problems:
            loader = p.train_data_loader
            batch = p._convert_batch(loader[0][0]) if loader else p.get_batch()
            out[p.name] = float(p.eval_loss(ctx, batch)[0])
    return out


def _group_step_check(card):
    """LBI at its defaults with features_lr 0.08 and classifier_lr 0.02, one
    driver step on the card: each finetune leaf moved by -lr of its group
    times its momentum trace (the first step's trace is the gradient)."""
    import torch

    engine = _program_engine("lbi", LBI_GROUPS + ["--train_iters", "1"], "cuda", False)
    before = dict(engine.states["finetune"]["params"])
    engine.run()
    state = engine.states["finetune"]
    traces = {k: v for g in state["opt_state"]["groups"] for k, v in g["trace"].items()}
    worst = {}
    for name, p in state["params"].items():
        lr = 0.08 if name.startswith("layers.0.") else 0.02
        want = -lr * traces[name]
        worst[name] = float((p - before[name] - want).abs().max() / want.abs().max())
    labels = engine.finetune.optimizer.labels
    log(f"[lbi] group check [{card}]: groups {labels}, lrs "
        f"{[m['lr'] for m in engine.finetune.optimizer.group_meta]}; relative |step - (-lr x "
        f"trace)| by leaf {worst}")
    assert max(worst.values()) <= 1e-5, worst
    del engine
    _free()
    return worst


PROGRAM_CELLS = {  # name: (argv, global steps a period, problems' counts a period, periods,
    # the driver steps before the compiled schedule's period starts: IUC's
    # starts after 2 inner1 steps and 1 inner2 step)
    "iuc": (["--valid_step", "1000000"], 4, [1, 2, 4], (3, 8), 2),
    "lbi": (LBI_GROUPS, 1, [1, 1, 1], (3, 20), 0),
    "imaml": ([], 20, [4, 20], (3, 5), 0),
}


def program_cell(name, card):
    """A program at its JAX example's defaults (LBI with features_lr 0.08 and
    classifier_lr 0.02), float32, TF32 off: driver mode, then compiled
    (IUC, LBI). ``warmup`` + ``steady`` timed periods (an IUC outer period
    is 4 inner1 steps, an iMAML meta update 20 inner steps) and one profiled
    (the card's kernels): period, busy, idle, launches, peak, capture; the
    counts a period and the paths; the fixed-batch losses of the two modes
    after each warm-up period; 0 launches of B1-B8."""
    from betty_tpu_torch.compile import BlockRunner

    argv, unroll, per_period, (warmup, steady), prefix = PROGRAM_CELLS[name]
    periods = warmup + steady + 1
    modes = ("driver", "compiled") if name != "imaml" else ("driver",)
    out, losses = {}, {}
    for mode in modes:
        tag = f"[{name}] defaults {mode} [{card}]"
        t0 = time.time()
        engine = _program_engine(name, argv, "cuda", mode == "compiled")
        n_params = sum(t.numel() for s in engine.states.values() for t in s["params"].values())
        log(f"{tag} build_engine {time.time() - t0:.1f} s; parameters {n_params}")
        if prefix:
            # both modes time the same spans: the compiled schedule's periods
            engine.train_iters = prefix
            engine.run()
        if name != "imaml":
            probe = BlockRunner(engine, schedule_only=True)
            assert probe.live_phase() == probe.initial_phase and probe.period == unroll
        counts0 = [p.count for p in engine.problems]
        seen = losses[mode] = []
        validate = engine.maybe_validate_checkpoint

        def hook(window=1, _engine=engine, _seen=seen, _validate=validate):
            stop = _validate(window)
            if len(_seen) < warmup and (_engine.global_step - prefix) % unroll == 0:
                _seen.append(_list_fixed_losses(_engine))
            return stop

        engine.maybe_validate_checkpoint = hook
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, unroll, periods, tag, profiled="card",
                                           offset=prefix)
        row = out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        row["launches"] = report["launches"] if report else None
        counts = [p.count - c for p, c in zip(engine.problems, counts0)]
        paths = {p.name: [[q.name for q in path] for path in p.paths]
                 for p in engine.problems if p.paths}
        if mode == "compiled":
            r = engine.block_runner
            row["capture_s"], row["warmup_s"] = r.capture_seconds, r.warmup_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}; capture "
                f"{r.capture_seconds:.3f} s (two warm-up periods {r.warmup_seconds:.3f} s)")
            assert r.captures == 1 and r.replays == periods, (r.captures, r.replays)
        final = _list_fixed_losses(engine)
        ours = _port_launches()
        log(f"{tag} counts over the timed periods {counts} ({per_period} a period); paths "
            f"{paths}; fixed-batch losses "
            f"after periods 1..{warmup} {seen}, at the end {final}; launches of B1-B8 {ours}")
        assert counts == [c * periods for c in per_period], counts
        if name == "iuc":
            assert len(paths["outer"]) == 3, paths
        if name == "lbi":
            assert len(paths["reweight"]) == 2, paths
        assert all(math.isfinite(v) for d in seen + [final] for v in d.values())
        assert all(n == 0 for n in ours.values()), ours
        del engine
        _free()
    if len(modes) == 2:
        diffs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in a)
                 for a, b in zip(losses["driver"], losses["compiled"])]
        out["loss_diffs"] = diffs
        log(f"[{name}] [{card}] compiled vs driver: relative difference of the fixed-batch "
            f"losses after periods 1..{warmup}: {diffs} (tol 1e-3)")
        assert max(diffs) <= 1e-3, diffs
    return out


def programs_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    for name in ("iuc", "lbi", "imaml"):
        program_small_phase(name, card)
    _group_step_check(card)
    for name in ("iuc", "lbi", "imaml"):
        program_cell(name, card)
    log(f"[programs] [{card}] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# pruning: ImageNet data pruning (a ResNet-50 student under a two-feature
# Meta-Weight-Net, darts, an EMA teacher in the classifier's state, device
# augmentation); ppo: PPO with a host-side simulator and rollout env. Neither
# runs a kernel of the port: cuDNN convolutions and BatchNorm, cuBLAS
# products (the augmentation's resampling among them), as the JAX package's
# are XLA's.
# ---------------------------------------------------------------------------

PRUNING_SMALL = ["--batch_size", "4", "--image_size", "32", "--num_classes", "10", "--width",
                 "8", "--stages", "1", "1", "--gas", "2", "--ema_decay", "0.9", "--train_size",
                 "32", "--meta_size", "16", "--train_iters", "8"]  # 4 meta-periods
PRUNING_AUGMENT = ["--image_size", "40", "--crop_size", "32", "--augment", "device"]
RESNET50_PARAMS = 25_557_032
PRUNING_CELLS = {  # name: (argv beside --device_data, modes)
    "fp32": ([], ("driver", "compiled")),
    "augment": (["--augment", "device"], ("compiled",)),
    "bf16": (["--precision", "bf16"], ("compiled",)),
}


def _host_draws(rng, images):
    """Crop and flip draws of ``imagenet_train_transform`` made on the host
    from the step seed, in float64 (the card's and the CPU's generators draw
    different numbers)."""
    import torch

    gen = torch.Generator().manual_seed(int(rng))
    u = torch.rand(5, images.shape[0], generator=gen, dtype=torch.float64)
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    draws = {"area": u[0] * (1.0 - 0.08) + 0.08, "log_ratio": u[1] * (hi - lo) + lo,
             "y": u[2], "x": u[3], "flip": u[4] < 0.5}
    return {k: v.to(images.device) for k, v in draws.items()}


def _prune_engine(argv, device, compiled, states=None, dtype=None, draws=None):
    """The pruning example's engine on ``device``; ``states`` (CPU tensors)
    replace its own, ``dtype`` casts the states and the loaders' images,
    ``draws`` replaces the classifier's crop and flip draws."""
    import numpy as np
    import torch
    from betty_tpu_torch.examples import imagenet_pruning as ex
    from betty_tpu_torch.utils import tree_map

    engine = ex.build_engine(ex.parse_args(
        argv + ["--device", device] + (["--compile_blocks"] if compiled else [])))
    engine.config.block_periods = 1
    engine.classifier.draws = draws
    if states is not None:
        engine.states = tree_map(lambda t: t.to(device, copy=True) if torch.is_tensor(t) else t,
                                 states)
    if dtype is not None:
        engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and
                                 t.is_floating_point() else t, engine.states)
        for p in engine.problems:
            for ld in p.train_data_loader:
                ld.arrays = (np.asarray(ld.arrays[0], str(dtype).split(".")[1]),
                             *ld.arrays[1:])
    return engine


def _teacher_moved(engine, states):
    import torch

    before = states["classifier"]["extra"]["teacher_params"]
    after = engine.states["classifier"]["extra"]["teacher_params"]
    return max(float((after[k].double().cpu() - before[k].double()).abs().max()) for k in before)


def pruning_small_phase(which, card, device="cuda"):
    """The pruning program at ``tests/test_examples2.py``'s sizes (B4, 32x32,
    stages [1, 1], width 8, ``--gas 2``; ``augment``: 40 -> 32 crops) for 4
    meta-periods in float64 (cuDNN deterministic): on the card against the
    CPU from the same weights within 1e-9 relative (crop draws made on the
    host on both sides), and compiled against driver mode on the card bit
    for bit (the example's own draws); the EMA teacher moved in every run.
    B1-B8 launch 0 times."""
    import torch

    argv = PRUNING_SMALL + (PRUNING_AUGMENT if which == "augment" else [])
    tag = f"[pruning small] {which} [{card}]"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _reset_port_launches()
    host = _host_draws if which == "augment" else None
    t0 = time.time()
    try:
        states = _prune_engine(argv, "cpu", False, dtype=torch.float64).states
        runs = {}
        for label, dev, compiled, draws in (("cpu", "cpu", False, host),
                                            ("card", device, False, host),
                                            ("driver", device, False, None),
                                            ("compiled", device, True, None)):
            if label == "driver" and host is None:
                runs["driver"] = runs["card"]
                continue
            engine = _prune_engine(argv, dev, compiled, states, torch.float64, draws)
            engine.run()
            runs[label] = engine
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card_err = _rel_err(runs["cpu"].states, runs["card"].states)
    comp_err = _state_err(runs["driver"].states, runs["compiled"].states)
    runner = runs["compiled"].block_runner
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    moved = {k: _teacher_moved(e, states) for k, e in runs.items()}
    ours = _port_launches()
    log(f"{tag}: card vs CPU max relative |param, statistic or teacher diff| {card_err:.3e} "
        f"(tol 1e-9); compiled vs driver on the card max |state diff| {comp_err:.3e} (bit for "
        f"bit), captures {runner.captures}, replays {runner.replays} of {runner.periods_run} "
        f"periods; teacher moved {moved}; counts {counts}; launches of B1-B8 {ours}; "
        f"{time.time() - t0:.1f} s")
    assert card_err <= 1e-9 and comp_err == 0.0, (card_err, comp_err)
    assert runner.periods_run >= 2 and (device != "cuda" or (runner.captures == 1
                                                             and runner.replays >= 2))
    assert all(c == [4, 8] for c in counts.values()), counts
    assert all(m > 0 for m in moved.values()), moved
    assert all(n == 0 for n in ours.values()), ours
    del runs
    _free()
    return card_err, comp_err


def wide_resnet_check(card, device="cuda"):
    """``WideResNet(10, 2)`` in float64 (cuDNN deterministic), card against
    CPU from the same weights: train-mode logits and one SGD step (lr 0.1)
    of its parameters, within 1e-9 relative."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from betty_tpu_torch.models import WideResNet

    net = WideResNet(10, 2).double()
    x = torch.tensor(np.random.RandomState(0).randn(8, 32, 32, 3))
    y = torch.tensor(np.arange(8) % 10)
    params = {k: v.detach() for k, v in net.named_parameters()}
    stats = {k: v.detach() for k, v in net.named_buffers()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for dev in ("cpu", device):
            p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
            s = {k: v.to(dev) for k, v in stats.items()}
            logits = torch.func.functional_call(net.to(dev), {**p, **s}, (x.to(dev),),
                                                {"train": True, "updates": {}})
            grads = torch.autograd.grad(F.cross_entropy(logits, y.to(dev)), list(p.values()))
            out[dev] = (logits.detach().cpu(), {k: (v - 0.1 * g).detach().cpu()
                                                for (k, v), g in zip(p.items(), grads)})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, p0), (l1, p1) = out["cpu"], out[device]
    logit_err = float((l0 - l1).abs().max() / l0.abs().max())
    step_err = max(float((p0[k] - p1[k]).abs().max()) for k in p0) / max(
        float(v.abs().max()) for v in p0.values())
    log(f"[pruning] WideResNet(10, 2) [{card}]: {sum(v.numel() for v in params.values())} "
        f"parameters; card vs CPU relative |logit diff| {logit_err:.3e}, |param diff after one "
        f"SGD step| {step_err:.3e} (tol 1e-9)")
    assert logit_err <= 1e-9 and step_err <= 1e-9, (logit_err, step_err)
    net.to("cpu")
    _free()


def _transform_device_ms(engine):
    """Device time and launches of one period's transforms (3 train, 1
    eval) at the cell's shapes, from the profiler's kernel durations (a
    clock around them would time the host's enqueue of their small ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from betty_tpu_torch.data import imagenet_eval_transform, imagenet_train_transform
    from betty_tpu_torch.utils import seeded_generator

    loader = engine.classifier.train_data_loader[0]
    images = loader.arrays[0][:loader.batch_size]
    crop = engine.classifier.cfg["crop_size"]

    def period():
        for seed in range(3):
            imagenet_train_transform(images, seeded_generator(seed, images.device),
                                     out_size=crop)
        imagenet_eval_transform(images, out_size=crop)

    period()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        period()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    return sum(t for t, _, _ in kernels), sum(c for _, c, _ in kernels)


def pruning_cell(name, card, warmup=1, steady=3):
    """ImageNet data pruning at the JAX example's defaults (ResNet-50, B32,
    224x224, 1,000 classes, ``--gas 1``, TF32 off, ``--device_data``),
    ``name``: fp32 in driver mode and compiled, ``--augment device``
    (crops 224) and ``--precision bf16`` compiled. ``warmup`` + ``steady``
    timed periods and one profiled (the card's kernels): period, busy, idle,
    launches, peak, capture and its warm-up part; counts 1:1 a period and
    one path into the reweighter; the fixed-batch losses after each warm-up
    period; the batch statistics' dtype; the transforms' share of device
    time (augment); 0 launches of B1-B8."""
    import torch
    from betty_tpu_torch.compile import BlockRunner

    extra, modes = PRUNING_CELLS[name]
    periods = warmup + steady + 1
    out, losses = {}, {}
    for mode in modes:
        tag = f"[pruning] ResNet-50 {name} {mode} [{card}]"
        t0 = time.time()
        engine = _prune_engine(["--device_data"] + extra, "cuda", mode == "compiled")
        n_params = sum(t.numel() for t in engine.states["classifier"]["params"].values())
        log(f"{tag} build_engine {time.time() - t0:.1f} s; classifier parameters {n_params} in "
            f"{len(engine.states['classifier']['params'])} leaves")
        assert n_params == RESNET50_PARAMS
        probe = BlockRunner(engine, schedule_only=True)
        assert probe.live_phase() == probe.initial_phase and probe.period == 1
        seen = losses[mode] = []
        validate = engine.maybe_validate_checkpoint

        def hook(window=1, _engine=engine, _seen=seen, _validate=validate):
            stop = _validate(window)
            if len(_seen) < warmup:
                _seen.append(_fixed_losses(_engine))
            return stop

        engine.maybe_validate_checkpoint = hook
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, 1, periods, tag, _op_class, profiled="card")
        row = out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        row["launches"] = report["launches"] if report else None
        counts = [p.count for p in engine.problems]
        paths = {p.name: [[q.name for q in path] for path in p.paths]
                 for p in engine.problems if p.paths}
        if mode == "compiled":
            r = engine.block_runner
            row["capture_s"], row["warmup_s"] = r.capture_seconds, r.warmup_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}; capture "
                f"{r.capture_seconds:.3f} s (two warm-up periods {r.warmup_seconds:.3f} s)")
            assert r.periods_run == periods and (not r.on_card or (r.captures, r.replays) == (
                1, periods)), (r.captures, r.replays)
        stats = engine.states["classifier"]["extra"]["batch_stats"]
        dtypes = sorted({str(t.dtype) for t in stats.values()})
        if name == "augment" and report:
            # a period: the classifier's step and darts' two re-evaluations
            # take the train transform, the reweighter's step the eval one
            row["resample_ms"], launches = _transform_device_ms(engine)
            log(f"{tag} a period's transforms (3 train, 1 eval) alone: device time "
                f"{row['resample_ms']:.4f} ms in {launches} launches, "
                f"{row['resample_ms'] / report['busy_ms']:.4f} of the period's device time")
        final = _fixed_losses(engine)
        ours = _port_launches()
        log(f"{tag} counts {counts} ({periods} periods, 1:1 a period); paths {paths}; batch "
            f"statistics {dtypes}; fixed-batch losses after periods 1..{warmup} {seen}, at the "
            f"end {final}; launches of B1-B8 {ours}")
        assert counts == [periods, periods], counts
        assert len(paths["reweight"]) == 1, paths
        assert dtypes == ["torch.float32"], dtypes
        assert all(math.isfinite(v) for d in seen + [final] for v in d.values())
        assert all(n == 0 for n in ours.values()), ours
        row["losses"] = seen
        del engine
        _free()
    if len(modes) == 2:
        diffs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in a)
                 for a, b in zip(losses["driver"], losses["compiled"])]
        out["loss_diffs"] = diffs
        log(f"[pruning] fp32 [{card}] compiled vs driver: relative difference of the fixed-batch "
            f"losses after periods 1..{warmup}: {diffs} (tol 1e-3)")
        assert max(diffs) <= 1e-3, diffs
    return out


def pruning_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    for which in ("plain", "augment"):
        pruning_small_phase(which, card)
    wide_resnet_check(card)
    rows = {name: pruning_cell(name, card) for name in PRUNING_CELLS}
    fp32 = rows["fp32"]["compiled"]["losses"]
    for name in ("augment", "bf16"):
        log(f"[pruning] [{card}] fixed-batch losses after periods 1..3, {name} compiled "
            f"{rows[name]['compiled']['losses']} beside fp32 compiled {fp32}")
    log(f"[pruning] [{card}] phase done in {time.time() - t0:.1f} s")


PPO_SMALL = ["--n_envs", "4", "--horizon", "32", "--train_iters", "8",
             "--epochs_per_rollout", "4"]


def _ppo_engine(argv, device, states=None, dtype=None):
    import torch
    from betty_tpu_torch.examples import ppo as ex
    from betty_tpu_torch.utils import tree_map

    engine = ex.build_engine(ex.parse_args(argv + ["--device", device]))
    if states is not None:
        engine.states = tree_map(lambda t: t.to(device, copy=True) if torch.is_tensor(t) else t,
                                 states)
    if dtype is not None:
        engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and
                                 t.is_floating_point() else t, engine.states)
    return engine


def ppo_small_phase(card, device="cuda"):
    """The PPO program at ``tests/test_examples2.py``'s arguments (4 envs,
    horizon 32, 8 iterations, a rollout every 4) in float64 on the card
    against the CPU from the same weights: parameters within 1e-9 relative,
    the last rollout's actions equal, counts 8:8. B1-B8 launch 0 times."""
    import numpy as np
    import torch

    _reset_port_launches()
    t0 = time.time()
    states = _ppo_engine(PPO_SMALL, "cpu", dtype=torch.float64).states
    runs = {}
    for label, dev in (("cpu", "cpu"), ("card", device)):
        runs[label] = _ppo_engine(PPO_SMALL, dev, states, torch.float64)
        runs[label].run()
    err = _rel_err(runs["cpu"].states, runs["card"].states)
    moved = _rel_err(states, runs["card"].states)
    same_actions = np.array_equal(runs["cpu"].env.rollout["act"], runs["card"].env.rollout["act"])
    adv = float(np.abs(runs["cpu"].env.rollout["adv"] - runs["card"].env.rollout["adv"]).max())
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    ours = _port_launches()
    log(f"[ppo small] [{card}]: card vs CPU max relative |param diff| {err:.3e} (tol 1e-9; "
        f"moved {moved:.3e}); last rollout's actions equal {same_actions}, max |advantage "
        f"diff| {adv:.3e}; counts {counts}; launches of B1-B8 {ours}; {time.time() - t0:.1f} s")
    assert err <= 1e-9 and moved > 0 and same_actions, (err, moved, same_actions)
    assert all(c == [8, 8] for c in counts.values()), counts
    assert all(n == 0 for n in ours.values()), ours
    del runs
    _free()
    return err


def _d2h_copies(kernels):
    return sum(c for _, c, name in kernels if "DtoH" in name or "Device -> " in name)


def ppo_cell(card, device="cuda"):
    """PPO at the JAX example's defaults (8 envs, horizon 128, 200
    iterations, a rollout every 8), driver mode: seconds per iteration (the
    iterations that collect a rollout apart), seconds per rollout; one
    rollout and its 8 iterations under the profiler (the card's kernels and
    copies): launches and device-to-host copies of the rollout, busy and
    idle of the block; peak memory; counts 200:200; ``mean_return``. B1-B8
    launch 0 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tag = f"[ppo] defaults driver [{card}]"
    engine = _ppo_engine([], device)
    env = engine.env
    rollouts, ends, reads = [], [], []
    step, outputs = env.step, env._outputs
    prof = {}

    def counted(problem, obs):
        reads[-1] += 1
        return outputs(problem, obs)

    env._outputs = counted

    def timed_step():
        if len(rollouts) == 2:
            torch.cuda.synchronize()
            prof["rollout"] = profile(activities=[ProfilerActivity.CUDA])
            prof["rollout"].__enter__()
        t = time.time()
        reads.append(0)
        step()
        rollouts.append(time.time() - t)
        if "rollout" in prof and "rollout_done" not in prof:
            prof["rollout"].__exit__(None, None, None)
            prof["rollout_done"] = True

    env.step = timed_step
    validate = engine.maybe_validate_checkpoint

    def hook(window=1):
        stop = validate(window)
        torch.cuda.synchronize()
        ends.append(time.time())
        return stop

    engine.maybe_validate_checkpoint = hook
    _reset_port_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    total = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    seconds = [b - a for a, b in zip([t0] + ends, ends)]
    with_rollout = [s for i, s in enumerate(seconds) if i % 8 == 0]
    without = [s for i, s in enumerate(seconds) if i % 8 != 0]
    rollout_kernels = _device_kernels(prof["rollout"])
    launches = sum(c for _, c, _ in rollout_kernels)
    copies = _d2h_copies(rollout_kernels)
    counts200 = [p.count for p in engine.problems]
    # one more rollout block (a rollout and its 8 iterations) under the profiler
    engine.train_iters = 8
    engine.maybe_validate_checkpoint = validate
    env.step, env._outputs = step, outputs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as block:
        tb = time.time()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - tb) * 1e3
    report = profile_report(block, wall_ms, tag + " [a rollout and 8 iterations]", _op_class)
    counts = [p.count for p in engine.problems]
    ours = _port_launches()
    q1, med, q3 = _quartiles(without)
    r1, rmed, r3 = _quartiles(rollouts[1:])
    log(f"{tag} {total:.3f} s for 200 iterations; s/iteration without a rollout median "
        f"{med:.6f} quartiles {q1:.6f} / {q3:.6f}, with one median "
        f"{_quartiles(with_rollout[1:])[1]:.6f}; s/rollout (after the first) median {rmed:.6f} "
        f"quartiles {r1:.6f} / {r3:.6f}; a rollout's kernel launches {launches}, host reads "
        f"of the networks' outputs {reads[2]} (each a synchronising copy; the profiler saw "
        f"{copies} device-to-host copies); peak {peak:.3f} GiB; counts {counts200} after 200 "
        f"iterations, {counts} with the profiled block; mean_return {env.mean_return}; "
        f"launches of B1-B8 {ours}")
    assert counts200 == [200, 200] and counts == [208, 208], (counts200, counts)
    assert set(reads) == {2 * env.horizon + 1}, reads
    assert math.isfinite(env.mean_return) and env.mean_return > 0
    assert all(n == 0 for n in ours.values()), ours
    del engine
    _free()
    return {"median": med, "q1": q1, "q3": q3, "rollout_s": rmed, "launches": launches,
            "reads": reads[2], "d2h_copies": copies, "peak_gib": peak,
            "busy_ms": report["busy_ms"] if report else None, "wall_ms": wall_ms}


def ppo_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    ppo_small_phase(card)
    ppo_cell(card)
    log(f"[ppo] [{card}] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# moe: the Switch MoE feed-forward layer (``models/moe.py``) under a
# Meta-Weight-Net reweighter (``examples/moe_reweighting.py``); tutorials:
# ``test_install``, the tutorials and ``prefetch_to_device``. Neither runs a
# kernel of the port: the MoE's dispatch, expert and combine einsums are
# cuBLAS products, as the JAX package's are XLA's.
# ---------------------------------------------------------------------------

MOE_SMALL = ["--dim", "16", "--hidden", "32", "--experts", "4", "--tokens", "64",
             "--val_tokens", "32", "--dense", "--train_iters", "4"]  # tests/test_ep.py's program
MOE_PARAMS = 8 * (768 * 3072 * 2 + 3072 + 768) + 768 * 8 + 768 * 2  # the inner problem's
MOE_MATMULS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _moe_engine(argv, device, compiled, states=None, dtype=None):
    """The MoE program on ``device``; ``states`` (CPU tensors) replace its
    own and ``dtype`` casts the states and the batches."""
    import torch
    from betty_tpu_torch.examples import moe_reweighting as ex
    from betty_tpu_torch.utils import tree_map

    engine = ex.build_engine(ex.parse_args(
        argv + ["--device", device] + (["--compile_blocks"] if compiled else [])))
    engine.config.block_periods = 1
    if states is not None:
        engine.states = tree_map(lambda t: t.to(device, copy=True) if torch.is_tensor(t) else t,
                                 states)
    if dtype is not None:
        engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and
                                 t.is_floating_point() else t, engine.states)
        for prob in engine.problems:
            (x, y), = prob.train_data_loader[0]
            prob.train_data_loader[0][0] = (x.to(dtype), y)
    return engine


def _tree_rel_err(a_states, b_states):
    """Largest |difference| of two engines' parameters, relative to the
    largest |value| of that problem's parameters (nested dicts)."""
    from betty_tpu_torch.utils import tree_leaves

    err = 0.0
    for name, a in a_states.items():
        la, lb = tree_leaves(a["params"]), tree_leaves(b_states[name]["params"])
        assert len(la) == len(lb), name
        scale = max(float(t.abs().max()) for t in lb) or 1.0
        diff = max(float((x.double().cpu() - y.double().cpu()).abs().max())
                   for x, y in zip(la, lb))
        err = max(err, diff / scale)
    return err


def moe_layer_check(card):
    """``moe_ffn`` at DIM 16 / HID 32 / E 4 / T 64 in float64 on the card
    against the CPU from the same weights, for capacities T, 2 and the
    default: ``y``, ``aux`` and the gradients of every parameter and of
    ``x`` within 1e-12 relative."""
    import torch
    from betty_tpu_torch.models import moe

    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(gen, 16, 32, 4, dtype=torch.float64)
    x = torch.randn(64, 16, generator=gen, dtype=torch.float64)
    g = torch.randn(64, 16, generator=gen, dtype=torch.float64)
    worst = {}
    for cap in (64, 2, None):
        out = []
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in params.items()}
            xd = x.to(dev, copy=True).requires_grad_(True)
            y, aux = moe.moe_ffn(p, xd, capacity=cap)
            (torch.sum(y * g.to(dev)) + aux).backward()
            out.append([y.detach(), aux.detach(), xd.grad] + [p[k].grad for k in sorted(p)])
        errs = [float((a - b.cpu()).abs().max()) / (float(a.abs().max()) or 1.0)
                for a, b in zip(*out)]
        dropped = int((out[0][0] == 0).all(dim=1).sum())
        worst[str(cap)] = max(errs)
        log(f"[moe small] [{card}] moe_ffn capacity {cap or 'default (1.25)'}: card vs CPU max "
            f"relative diff of y, aux and the gradients {max(errs):.3e} (tol 1e-12); tokens "
            f"dropped {dropped}")
        drops = {64: False, 2: True}.get(cap)  # none at capacity T, some at 2
        assert max(errs) <= 1e-12 and drops in (None, dropped > 0), (errs, dropped)
    return worst


def moe_small_phase(card):
    """``tests/test_ep.py``'s program (DIM 16, every token to its expert,
    darts unroll 2, 4 iterations) in float64 on the card against the CPU
    from the same weights within 1e-12 relative, and compiled against driver
    mode on the card bit for bit. B1-B8 launch 0 times."""
    import torch

    _reset_port_launches()
    t0 = time.time()
    states = _moe_engine(MOE_SMALL, "cpu", False, dtype=torch.float64).states
    runs = {}
    for label, device, compiled in (("cpu", "cpu", False), ("card", "cuda", False),
                                    ("compiled", "cuda", True)):
        runs[label] = _moe_engine(MOE_SMALL, device, compiled, states, torch.float64)
        runs[label].run()
    torch.cuda.synchronize()
    err = _tree_rel_err(runs["cpu"].states, runs["card"].states)
    moved = _tree_rel_err(states, runs["card"].states)
    comp = _state_err(runs["card"].states, runs["compiled"].states)
    runner = runs["compiled"].block_runner
    counts = {k: [p.count for p in e.problems] for k, e in runs.items()}
    ours = _port_launches()
    log(f"[moe small] [{card}] program: card vs CPU max relative |param diff| {err:.3e} (tol "
        f"1e-12; moved {moved:.3e}); compiled vs driver on the card max |state diff| {comp:.3e} "
        f"(bit for bit), captures {runner.captures}, replays {runner.replays} of "
        f"{runner.periods_run} periods; counts {counts}; launches of B1-B8 {ours}; "
        f"{time.time() - t0:.1f} s")
    assert err <= 1e-12 and moved > 0 and comp == 0.0, (err, moved, comp)
    assert runner.periods_run == 2 and (not runner.on_card or (
        runner.captures == 1 and runner.replays >= 1)), (runner.captures, runner.replays)
    assert all(c == [2, 4] for c in counts.values()), counts
    assert all(n == 0 for n in ours.values()), ours
    del runs
    _free()


def _moe_split(prof, tokens, slots, experts):
    """Device time (ms) of a profiled period's kernels by the matmul that
    launched them: ``dispatch/combine`` (a product whose operands hold both
    the token count and ``E * C``: the two routing einsums and their
    backward), ``experts`` (a batched product over the ``E`` experts: the
    two expert einsums and their backward) and ``rest`` (every other
    kernel, by op class). Reads the profiler's op tree (CPU and CUDA
    activities, shapes recorded); None where it holds no kernel."""
    split = {}
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        ms = sum(k.duration for k in kernels) / 1e3
        if not ms:
            continue
        op = evt
        while op is not None and op.name not in MOE_MATMULS:
            op = op.cpu_parent
        dims = [d for shape in (op.input_shapes if op is not None else []) for d in shape]
        if op is None:
            key = "rest " + _op_class(kernels[0].name)
        elif tokens in dims and slots in dims:
            key = "dispatch/combine"
        elif op.name in ("aten::bmm", "aten::baddbmm") and op.input_shapes[0][:1] == [experts]:
            key = "experts"
        else:
            key = "rest matmul"
        split[key] = split.get(key, 0.0) + ms
    return split or None


def moe_cell(card, name, argv, modes, warmup=2, steady=5):
    """The program at Switch-Base-8's widths (d_model 768, d_ff 3072, 8
    experts, capacity factor 1.25, 4,096 tokens a step), TF32 off, in each of
    ``modes``: ``warmup`` + ``steady`` timed periods (2 steps each) and one
    profiled (the card's kernels): period, busy, idle, launches, peak,
    capture; the fixed-batch losses after each warm-up period; in driver
    mode one more period profiled with its ops, for the device time of the
    dispatch/combine einsums, the expert products and the rest. B1-B8 launch
    0 times."""
    import torch
    from betty_tpu_torch.compile import BlockRunner
    from betty_tpu_torch.models import moe
    from betty_tpu_torch.utils import tree_leaves
    from torch.profiler import ProfilerActivity, profile

    periods = warmup + steady + 1
    out, losses = {}, {}
    for mode in modes:
        tag = f"[moe] Switch-Base-8 {name} {mode} [{card}]"
        t0 = time.time()
        engine = _moe_engine(argv, "cuda", mode == "compiled")
        n_params = sum(t.numel() for t in tree_leaves(engine.states["inner"]["params"]))
        args_t, slots = 4096, 8 * moe.expert_capacity(4096, 8)
        log(f"{tag} build_engine {time.time() - t0:.1f} s; inner parameters {n_params}, "
            f"capacity {slots // 8} an expert")
        assert n_params == MOE_PARAMS, n_params
        probe = BlockRunner(engine, schedule_only=True)
        assert probe.live_phase() == probe.initial_phase and probe.period == 2
        seen = losses[mode] = []
        validate = engine.maybe_validate_checkpoint

        def hook(window=1, _engine=engine, _seen=seen, _validate=validate):
            stop = _validate(window)
            if len(_seen) < warmup and _engine.global_step % 2 == 0:
                _seen.append(_list_fixed_losses(_engine))
            return stop

        engine.maybe_validate_checkpoint = hook
        _reset_port_launches()
        seconds, report, peak = _timed_run(engine, 2, periods, tag, _op_class, profiled="card")
        row = out[mode] = _cell_line(tag, seconds, report, peak, warmup)
        row["launches"] = report["launches"] if report else None
        if mode == "compiled":
            r = engine.block_runner
            row["capture_s"], row["warmup_s"] = r.capture_seconds, r.warmup_seconds
            log(f"{tag} captures {r.captures}, replays {r.replays}; capture "
                f"{r.capture_seconds:.3f} s (two warm-up periods {r.warmup_seconds:.3f} s)")
            assert r.periods_run == periods and (not r.on_card or (
                r.captures, r.replays) == (1, periods)), (r.captures, r.replays)
        else:
            engine.maybe_validate_checkpoint = validate
            engine.train_iters = 2
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                engine.run()
                torch.cuda.synchronize()
            split = row["split"] = _moe_split(prof, args_t, slots, 8)
            total = sum(split.values()) if split else float("nan")
            log(f"{tag} a period's device time by einsum (ops profiled): "
                + (", ".join(f"{k} {v:.2f} ms ({v / total:.3f})"
                             for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
                   if split else "not read") + f"; total {total:.2f} ms")
        counts = [p.count for p in engine.problems]
        final = _list_fixed_losses(engine)
        ours = _port_launches()
        log(f"{tag} counts {counts}; fixed-batch losses after periods 1..{warmup} {seen}, at "
            f"the end {final}; launches of B1-B8 {ours}")
        assert all(math.isfinite(v) for d in seen + [final] for v in d.values())
        assert all(n == 0 for n in ours.values()), ours
        row["losses"] = seen
        if name == "bf16":
            row["routing"] = moe_routing_check(engine, card)
        del engine
        _free()
    if len(modes) == 2:
        diffs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in a)
                 for a, b in zip(losses["driver"], losses["compiled"])]
        out["loss_diffs"] = diffs
        log(f"[moe] fp32 [{card}] compiled vs driver: fixed-batch losses after periods "
            f"1..{warmup}: driver {losses['driver']}, compiled {losses['compiled']}; relative "
            f"differences {diffs} (tol 1e-3)")
        assert max(diffs) <= 1e-3, diffs
    return out


def moe_routing_check(engine, card):
    """The routing of the inner problem's loss at the engine's parameters on
    its batch (one period's routing), under the engine's precision: the
    largest count of tokens routed to one expert (it must pass 256, where a
    bf16 count stops being exact), and in each expert the kept buffer
    positions exactly 0..min(n_e, C) - 1, each used once."""
    import torch
    from betty_tpu_torch.models import moe

    seen = []
    route = moe.route

    def recorded(probs, capacity, dtype):
        out = route(probs, capacity, dtype)
        seen.append((probs.dtype, capacity, out))
        return out

    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    moe.route = recorded
    try:
        with torch.no_grad():
            engine.inner.eval_loss(ctx, engine.inner.cur_batch)
    finally:
        moe.route = route
    dtype, capacity, (_, onehot, dispatch) = seen[0]
    routed = onehot.float().sum(0)
    used = dispatch.float().sum(0)  # [E, C]: tokens in each buffer slot
    kept = torch.minimum(routed, torch.tensor(float(capacity), device=routed.device))
    slots = torch.arange(capacity, device=used.device, dtype=used.dtype)
    want = (slots[None, :] < kept[:, None]).to(used.dtype)
    exact = bool(torch.equal(used, want))
    log(f"[moe] bf16 routing [{card}]: {len(seen)} routing call(s) in the inner loss, dtype "
        f"{dtype}, dispatch {dispatch.dtype}; tokens routed to each expert "
        f"{[int(v) for v in routed.tolist()]} (largest {int(routed.max())}, capacity "
        f"{capacity}); kept positions 0..min(n_e, C) - 1 each used once: {exact}")
    assert dtype == dispatch.dtype == torch.bfloat16
    assert int(routed.max()) > 256 and exact, (routed.tolist(), exact)
    return {"routed": [int(v) for v in routed.tolist()], "capacity": capacity}


def moe_phase(card):
    """Every line carries ``card``, the card's name and power limit."""
    t0 = time.time()
    moe_layer_check(card)
    moe_small_phase(card)
    rows = {"fp32": moe_cell(card, "fp32", [], ("driver", "compiled")),
            "bf16": moe_cell(card, "bf16", ["--precision", "bf16"], ("compiled",))}
    log(f"[moe] [{card}] fixed-batch losses after periods 1..3: fp32 driver "
        f"{rows['fp32']['driver']['losses']}, fp32 compiled {rows['fp32']['compiled']['losses']}, "
        f"bf16 compiled {rows['bf16']['compiled']['losses']}")
    log(f"[moe] [{card}] phase done in {time.time() - t0:.1f} s")
    return rows


# iterations of each tutorial's run: the JAX defaults of 3 (1,000) and 8 (100);
# 1, its baseline and 2 cut from 3,000 and 4 from 2,000 to 1,000, because a
# driver iteration of 1 and 2 takes about 16 ms on the card (3,000: 49 s each)
# and the moe and tutorials phases are held to 120 s together
TUTORIAL_ITERS = {  # 1, 2, 3 and 4 cut from 3,000, 3,000, 1,000 and 2,000 for the time limit
    "1_quick_start": 100, "1_quick_start --baseline": 100, "2_validation": 100,
    "3_logging": 100, "4_memory_optimization": 100, "8_custom_solver": 100,
}


def _tutorial(name):
    import importlib

    return importlib.import_module(f"betty_tpu_torch.tutorial.{name}")


def _fixed_tutorial_losses(engine):
    """Every problem's loss at the engine's parameters on the first batch of
    its loader, no graph."""
    import torch

    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    out = {}
    with torch.no_grad():
        for p in engine.problems:
            ld = p.train_data_loader[0]
            batch = p._convert_batch(tuple(a[:ld.batch_size] for a in ld.arrays))
            out[p.name] = float(p.eval_loss(ctx, batch)[0])
    return out


def _tensorboard_scalars(log_root):
    """``(scalar events, tags)`` written under ``log_root/betty_tensorboard``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events, tags = 0, set()
    for run in sorted(os.listdir(os.path.join(log_root, "betty_tensorboard"))):
        acc = EventAccumulator(os.path.join(log_root, "betty_tensorboard", run))
        acc.Reload()
        for tag in acc.Tags()["scalars"]:
            tags.add(tag)
            events += len(acc.Scalars(tag))
    return events, sorted(tags)


def tutorial_run(card, key):
    """One tutorial (``key``: its module name, ``--baseline`` for 1's
    baseline) at ``TUTORIAL_ITERS[key]`` iterations on the card, driver mode:
    seconds (synchronised), counts, the fixed-batch losses at the end,
    validation accuracy (2), the sink and its scalar events (3), the
    printed norm (8)."""
    import shutil

    import torch

    name, *flags = key.split()
    mod = _tutorial(name)
    iters = TUTORIAL_ITERS[key]
    extra = {}
    log_root = os.path.join(ROOT, "build", "tutorial_logs")
    here = os.getcwd()
    if name == "3_logging":  # the sink writes under the working directory
        shutil.rmtree(log_root, ignore_errors=True)
        os.makedirs(log_root)
        os.chdir(log_root)
    try:
        engine = mod.build_engine(mod.parse_args(flags + ["--train_iters", str(iters)]))
        torch.cuda.synchronize()
        t0 = time.time()
        engine.run()
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        os.chdir(here)
    losses = _fixed_tutorial_losses(engine)
    if name == "2_validation":
        engine.eval()
        extra["test_acc"] = float(engine.validation()["acc"])
        engine.train()
    if name == "3_logging":
        sink = type(engine.logger).__name__
        extra["sink"] = sink
        if sink == "TensorBoardLogger":
            engine.logger.writer.close()
            extra["scalar_events"], extra["tags"] = _tensorboard_scalars(log_root)
            assert extra["scalar_events"] == 3 * (iters // 100), extra
    if name == "8_custom_solver":
        extra["first_leaf_norm"] = mod.first_leaf_norm(engine)
    counts = [p.count for p in engine.problems]
    log(f"[tutorials] {key} [{card}]: {iters} iterations in {seconds:.3f} s "
        f"({iters / seconds:.1f} it/s), counts {counts}; fixed-batch losses at the end "
        f"{losses}; {extra}")
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert max(counts) == iters, counts
    if key == "1_quick_start":  # one more iteration under the profiler
        report = profile_period(engine, 1, f"[tutorials] {key} [{card}]", _op_class)
        extra["launches"] = report["launches"] if report else None
    del engine
    _free()
    return {"seconds": seconds, "losses": losses, **extra}


def tutorial6_run(card, iters=128):
    """Tutorial 6's four configurations at its defaults (``run_all``: each
    from a fresh engine, the card synchronised around its run, the capture
    included): meta-steps/s each."""
    mod = _tutorial("6_performance")
    t0 = time.time()
    rates = {}
    for name, rate, engine in mod.run_all("cuda", iters):
        counts = [p.count for p in engine.problems]
        runner = engine.block_runner
        blocks = (runner.periods_run, runner.replays) if runner is not None else (0, 0)
        losses = _fixed_tutorial_losses(engine)
        log(f"[tutorials] 6_performance {name} [{card}]: {rate:.1f} meta-steps/s over {iters} "
            f"(capture included), counts {counts}, periods in blocks and replays {blocks}; "
            f"fixed-batch losses {losses}")
        assert counts == [iters, iters] and all(math.isfinite(v) for v in losses.values())
        assert (blocks[0] > 0) == name.startswith("blocks"), (name, blocks)
        assert not runner or not runner.on_card or blocks[1] == blocks[0], blocks
        rates[name] = rate
        del engine
    _free()
    log(f"[tutorials] 6_performance [{card}]: {time.time() - t0:.1f} s")
    return rates


def install_run(card):
    """``test_install.main()`` at its defaults on the card."""
    import torch
    from betty_tpu_torch import test_install

    torch.cuda.synchronize()
    t0 = time.time()
    loss = test_install.main()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    log(f"[tutorials] test_install [{card}]: final outer loss {loss:.6f} (< 0.48), "
        f"{seconds:.3f} s")
    assert loss < 0.48, loss
    return {"loss": loss, "seconds": seconds}


def prefetch_check(card):
    """``prefetch_to_device`` on the card: numpy and pinned-or-not CPU
    tensor batches, sizes 1 to 3 and an iterator shorter than the size; each
    batch on the card, equal to the host's, in order, the last ones
    included, and readable by work queued on the consumer's stream."""
    import numpy as np
    import torch
    from betty_tpu_torch.data import prefetch_to_device

    rng = np.random.RandomState(0)
    host = [(rng.randn(128, 784).astype(np.float32), torch.from_numpy(rng.randint(0, 2, 128)),
             {"step": i}) for i in range(6)]
    checked = 0
    for size in (1, 2, 3):
        for n in (len(host), 2):
            got = list(prefetch_to_device(iter(host[:n]), size=size))
            sums = [float((x * 2).sum()) for x, _, _ in got]  # consumer-stream work
            assert len(got) == n and [d["step"] for _, _, d in got] == list(range(n))
            for (x, y, _), (hx, hy, _), s in zip(got, host, sums):
                assert x.is_cuda and y.is_cuda
                assert np.array_equal(x.cpu().numpy(), hx) and torch.equal(y.cpu(), hy)
                assert math.isclose(s, float(2 * torch.from_numpy(hx).double().sum()),
                                    rel_tol=1e-4)
                checked += 1
    log(f"[tutorials] prefetch_to_device [{card}]: {checked} batches on the card equal to the "
        f"host's, in order, sizes 1-3, iterators of 6 and 2 batches")
    return checked


def tutorials_phase(card):
    """Every line carries ``card``, the card's name and power limit. B1-B8
    launch 0 times."""
    t0 = time.time()
    _reset_port_launches()
    out = {"test_install": install_run(card)}
    for key in TUTORIAL_ITERS:
        out[key] = tutorial_run(card, key)
    out["6_performance"] = tutorial6_run(card)
    out["prefetch"] = prefetch_check(card)
    ours = _port_launches()
    log(f"[tutorials] [{card}] launches of B1-B8 {ours}; phase done in {time.time() - t0:.1f} s")
    assert all(n == 0 for n in ours.values()), ours
    return out


# ---------------------------------------------------------------------------
# dist: the data-parallel strategies (dp, zero, fsdp) over torch.distributed
# ---------------------------------------------------------------------------

DIST_TIMEOUT = 300  # seconds a leg's ranks may take, set-up included
DIST_OP_TIMEOUT = 120  # seconds a collective may wait for the other ranks
NORTH_ARGV = ["--model", "large", "--hypergradient", "sama", "--precision", "bf16",
              "--solver_precision", "fp32", "--unroll_steps", "5", "--batch_size", "32",
              "--seq_len", "128", "--device_data", "--train_iters", "10", "--train_size", "2048",
              "--meta_size", "512", "--device", "cuda", "--flash"]
DIST_T5_ARGV = ["--device", "cuda", "--train_iters", "12", "--no_shuffle", "--backend", "gloo"]
DIST_T5_BATCH = 64  # a rank's batch: the one-process run loads twice that


def _dist_launch(mode, world, out, extra_env=None):
    """``world`` ranks of ``--dist-worker mode out`` on a free local port,
    started together: the ``Popen``s."""
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for rank in range(world):
        env = dict(os.environ, BETTY_COORDINATOR_ADDRESS=f"localhost:{port}",
                   BETTY_NUM_PROCESSES=str(world), BETTY_PROCESS_ID=str(rank),
                   **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker", mode, out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _dist_wait(tag, procs, deadline):
    """Wait for every rank; any failure or timeout kills the rest and
    raises. Logs each rank's output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{tag}: a rank passed the {DIST_TIMEOUT} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith(("[dist", "[mp", "[pp")) or "Error" in line or "error" in line:
                log(f"{tag} rank {rank}: {line}")
        assert p.returncode == 0, f"{tag}: rank {rank} exited {p.returncode}:\n{out[-3000:]}"


def _t5_engine(strategy, batch):
    """Tutorial 5's program on the card in float64."""
    import importlib

    import numpy as np
    import torch
    from betty_tpu_torch.utils import tree_map

    t5 = importlib.import_module("betty_tpu_torch.tutorial.5_distributed_training")
    engine = t5.build_engine(t5.parse_args(DIST_T5_ARGV + ["--strategy", strategy,
                                                           "--batch_size", str(batch)]))
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    for p in engine.problems:
        for dl in p.train_data_loader:
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])
    return engine


def _whole_params(engine):
    from betty_tpu_torch.utils import tree_map

    return {p.name: tree_map(lambda v: v.detach().cpu().clone(), p.full_state()["params"])
            for p in engine.problems}


def _rel_apart(got, want, start):
    """``(|got - want| / |want - start|, |want - start|)``, L2 norms over
    every leaf in float64: how far two runs from one start end apart,
    against how far the reference moved (1 for a run that never stepped)."""
    from betty_tpu_torch.utils import tree_leaves

    apart = moved = 0.0
    for n in want:
        for g, w, s0 in zip(tree_leaves(got[n]), tree_leaves(want[n]), tree_leaves(start[n])):
            w = w.double()
            apart += float(((g.to(w.device).double() - w) ** 2).sum())
            moved += float(((w - s0.to(w.device).double()) ** 2).sum())
    moved = math.sqrt(moved)
    return (math.sqrt(apart) / moved if moved > 0 else math.inf), moved


def _north_run(strategy, tag, extra=(), start=None):
    """Two north-star meta-periods under ``strategy`` (``extra``: more
    arguments, a ``--mesh``): ``(params on the card, losses, periods, peak
    bytes, launches, engine)``. ``start``: a dict filled with the whole
    parameters before the run, on the host."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    t0 = time.time()
    engine = ex.build_engine(ex.parse_args(NORTH_ARGV + ["--strategy", strategy] + list(extra)))
    torch.cuda.synchronize()
    log(f"{tag} build_engine {time.time() - t0:.1f} s")
    losses, ends = [], []
    for prob in (engine.classifier, engine.reweight):
        orig = prob.one_step_descent

        def record(*a, _orig=orig, _name=prob.name, **kw):
            out = _orig(*a, **kw)
            losses.append((_name, out["loss"].detach().clone()))
            if _name == "reweight":
                torch.cuda.synchronize()
                ends.append(time.time())
            return out

        prob.one_step_descent = record
    if start is not None:
        start.update(_whole_params(engine))
    reset, counters = _counters("sama")
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    periods = [b - a for a, b in zip([t0] + ends, ends)]
    peak = torch.cuda.max_memory_allocated()
    params = {p.name: {k: v.clone() for k, v in p.full_state()["params"].items()}
              for p in engine.problems}
    return params, list(losses), periods, peak, launches, engine


def _nccl_kind(name):
    if "nccl" in name.lower():
        return "nccl"
    return "copy DtoD" if "memcpy dtod" in name.lower() else "other"


_DIST_FUNCS = {}


def _nccl_op(name):
    """The collective of an NCCL kernel (``AllReduce``, ``SendRecv``: the
    ring shifts, ``AllGather``, ``ReduceScatter``), else None."""
    m = re.search(r"nccl\w*?(AllReduce|SendRecv|AllGather|ReduceScatter|Broadcast)", name)
    return m.group(1) if m else None


def _group_labels(mesh):
    """``{id(process group): the mesh's name for it}``: ``batch``, ``model``
    and, on two model axes, each axis's."""
    if mesh is None:
        return {}
    labels = {id(mesh.batch_group): "batch", id(mesh.model_group): "model"}
    labels.update({id(g): a for a, g in mesh.axis_groups.items()})
    return labels


def _count_collectives(groups=None):
    """Counts of the collective calls the port makes, by name (the
    ``torch.distributed`` functions wrapped in place until
    ``_restore_collectives``); with ``groups`` (``_group_labels``) by name
    and the group's label."""
    import torch.distributed as dist

    _restore_collectives()
    counts = {}
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                 "batch_isend_irecv"):
        orig = _DIST_FUNCS[name] = getattr(dist, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            key = _name
            if groups and "group" in kw:
                key = f"{_name}:{groups.get(id(kw['group']), 'other')}"
            counts[key] = counts.get(key, 0) + 1
            return _orig(*a, **kw)

        setattr(dist, name, wrapped)
    return counts


def _restore_collectives():
    import torch.distributed as dist

    for name, fn in _DIST_FUNCS.items():
        setattr(dist, name, fn)
    _DIST_FUNCS.clear()


def _dist_north(go):
    """World of one over NCCL: the north star under default, then fsdp,
    once the file ``go`` exists (the card is then this process's alone)."""
    import torch
    from betty_tpu_torch import parallel
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    deadline = time.time() + DIST_TIMEOUT
    while not os.path.exists(go):
        if time.time() > deadline:
            raise TimeoutError(f"no {go} after {DIST_TIMEOUT} s")
        time.sleep(0.1)
    parallel.maybe_init_distributed("cuda", timeout=DIST_OP_TIMEOUT)
    assert torch.distributed.get_backend() == "nccl" and torch.distributed.get_world_size() == 1
    calls = _count_collectives()
    runs, start = {}, {}
    for strategy in ("default", "fsdp"):
        tag = f"[dist north {strategy}]"
        params, losses, periods, peak, launches, engine = _north_run(
            strategy, tag, start=start if strategy == "default" else None)
        log(f"{tag} meta-period seconds {periods} (the first includes warm-up); peak "
            f"{peak / 2**30:.2f} GiB; launches {launches}")
        assert launches == SAMA_S128, (launches, SAMA_S128)
        assert all(math.isfinite(float(x)) for _, x in losses)
        runs[strategy] = (params, losses, periods, peak)
        if strategy == "fsdp":
            held = {k: list(v.shape) for k, v in list(engine.states["classifier"]["params"]
                                                      .items())[:2]}
            log(f"{tag} first classifier leaves as held (one rank: whole) {held}; shard dims "
                f"of the state: {sorted(engine.classifier._shard_dims)}")
        # one more period of each under the profiler, the copies and NCCL
        # kernels apart
        calls.clear()
        rep = profile_period(engine, 5, f"{tag}", classify=_nccl_kind)
        kernels = (rep or {}).get("kernels", [])
        for kind in ("nccl", "copy DtoD"):
            ks = [(t, c) for t, c, n in kernels if _nccl_kind(n) == kind]
            log(f"{tag} {kind} in the profiled period: {sum(c for _, c in ks)} launches, "
                f"{sum(t for t, _ in ks):.3f} ms device time")
        log(f"{tag} collective calls in the profiled period: {dict(calls)}")
        assert (sum(calls.values()) > 0) == (strategy == "fsdp"), calls
        del engine
        _free()
    (pa, la, _, _), (pb, lb, _, _) = runs["default"], runs["fsdp"]
    same = all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in pa[n])
    same_losses = len(la) == len(lb) and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in zip(la, lb))
    log(f"[dist north] fsdp vs default at a world of one: parameters bit-equal {same}, "
        f"{len(la)} losses bit-equal {same_losses}")
    assert same and same_losses
    del runs, pb
    _free()
    _mp_world_one((pa, la), start, calls)  # the mp checks of a world of one
    del pa, start
    _free()
    _restore_collectives()
    _pp_world_one()  # the pp checks of a world of one
    # dp and zero at small width, the same check
    argv = SMALL_ARGV + ["--hypergradient", "sama", "--flash", "--dropout", "0.1",
                         "--device", "cuda"]
    small = {}
    for strategy in ("default", "dp", "zero"):
        engine = ex.build_engine(ex.parse_args(argv + ["--strategy", strategy]))
        engine.run()
        small[strategy] = _whole_params(engine)
        del engine
    for strategy in ("dp", "zero"):
        eq = all(torch.equal(small[strategy][n][k], t) for n, st in small["default"].items()
                 for k, t in st.items())
        log(f"[dist small] {strategy} vs default at a world of one (dropout 0.1): bit-equal {eq}")
        assert eq, strategy
    # compiled blocks under fsdp: the period's NCCL collectives captured
    runs = {}
    for compiled in (False, True):
        engine = ex.build_engine(ex.parse_args(
            argv + ["--strategy", "fsdp", "--train_iters", "12"]
            + (["--compile_blocks"] if compiled else [])))
        engine.run()
        runs[compiled] = _whole_params(engine)
        if compiled:
            runner = engine.block_runner
            log(f"[dist compiled] fsdp compiled: captures {runner.captures}, replays "
                f"{runner.replays}, periods {runner.periods_run}, capture "
                f"{runner.capture_seconds:.2f} s")
            assert runner.periods_run > 0
            assert (runner.captures, runner.replays) == ((1, runner.periods_run)
                                                         if runner.on_card else (0, 0))
        del engine
    eq = all(torch.equal(runs[True][n][k], t) for n, st in runs[False].items()
             for k, t in st.items())
    log(f"[dist compiled] fsdp compiled vs driver at a world of one: bit-equal {eq}")
    assert eq


def _dist_gloo2(out):
    """One of two ranks on the one card over gloo: tutorial 5's program in
    float64 under dp, zero and fsdp; rank 0 saves the whole parameters."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", backend="gloo", timeout=DIST_OP_TIMEOUT)
    got = {}
    for strategy in ("dp", "zero", "fsdp"):
        t0 = time.time()
        engine = _t5_engine(strategy, DIST_T5_BATCH)
        engine.run()
        got[strategy] = _whole_params(engine)
        shape = list(engine.states["classifier"]["params"]["layers.0.weight"].shape)
        log(f"[dist gloo2 {strategy}] rank {torch.distributed.get_rank()}: "
            f"{time.time() - t0:.2f} s, holds layers.0.weight {shape}")
        del engine
    if torch.distributed.get_rank() == 0:
        torch.save(got, out)
    torch.distributed.barrier()


def dist_worker(mode, out):
    """``--dist-worker``: one rank of a dist leg."""
    import torch

    assert torch.cuda.is_available(), "the dist legs run on the card"
    from betty_tpu_torch.ops import _build
    from betty_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the parent built them: found in build/kernels
    fa._lib("flash_single")
    fa._lib("flash_multi")
    if mode == "north":
        _dist_north(out)
    elif mode == "gloo2":
        _dist_gloo2(out)
    elif mode == "mpgloo2":
        _mp_gloo2(out)
    elif mode == "mpgloo4":
        _mp_gloo4(out)
    elif mode == "composedfour":
        _composed_four_rank(out)
    elif mode == "fourmoe":
        _mp_four_moe(out)
    elif mode.startswith("four:"):
        mesh, batch = mode[len("four:"):].rsplit(":", 1)
        _mp_four_rank(mesh, int(batch), out)
    elif mode.startswith("ppfour:"):
        pmode, rest = mode[len("ppfour:"):].split(":", 1)
        mesh, M = rest.rsplit(":", 1)
        _pp_four_rank(pmode, mesh, int(M) or None, out)
    else:
        raise ValueError(f"unknown dist worker mode {mode!r}")
    torch.distributed.destroy_process_group()
    return 0


def dist_phase(card):
    """The two-rank leg (and its one-process reference, here), then the
    world of one alone on the card, each in subprocesses (the world of one
    starts up beside the two-rank leg)."""
    t0 = time.time()
    deadline = t0 + DIST_TIMEOUT
    os.makedirs("build", exist_ok=True)
    out = os.path.abspath(os.path.join("build", "dist_gloo2.pt"))
    go = os.path.abspath(os.path.join("build", "dist_gloo2.done"))
    for f in (out, go):
        if os.path.exists(f):
            os.remove(f)
    gloo = _dist_launch("gloo2", 2, out)
    # the world of one starts up meanwhile and runs once ``go`` exists
    north = _dist_launch("north", 1, go)
    try:
        _dist_gloo2_check(card, gloo, out, deadline, t0)
        with open(go, "w"):
            pass
        _dist_wait("[dist north]", north, deadline)
    finally:
        for p in north:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[dist] [{card}] phase done in {time.time() - t0:.1f} s")


def _dist_gloo2_check(card, gloo, out, deadline, t0):
    """The two-rank leg's result against this process's one-process run on
    the global batch."""
    import torch

    ref_engine = _t5_engine("default", 2 * DIST_T5_BATCH)
    ref_engine.run()
    ref = _whole_params(ref_engine)
    del ref_engine
    _dist_wait("[dist gloo2]", gloo, deadline)
    got = torch.load(out, weights_only=True)
    errs = {s: max(float((got[s][n][k] - t).abs().max()) for n, st in ref.items()
                   for k, t in st.items()) for s in got}
    moved = max(float((got["dp"]["classifier"][k] - t).abs().max())
                for k, t in _whole_params(_t5_engine("default", 2 * DIST_T5_BATCH))
                ["classifier"].items())
    same = {s: all(torch.equal(got[s][n][k], got["dp"][n][k]) for n in got["dp"]
                   for k in got["dp"][n]) for s in ("zero", "fsdp")}
    log(f"[dist gloo2] [{card}] two ranks (gloo, CUDA tensors, float64) against one process "
        f"on the global batch: max |param diff| {errs} (tol 1e-10); zero/fsdp bit-equal to dp "
        f"{same}; moved from the start {moved:.3e}; {time.time() - t0:.1f} s")
    assert max(errs.values()) <= 1e-10 and all(same.values()) and moved > 0


# ---------------------------------------------------------------------------
# mp: tensor and expert parallelism (tp, ep) over torch.distributed
# ---------------------------------------------------------------------------

MP_TP_WORLD_ONE = ["--mesh", "dp:1,mdl:1"]
# tp against default at a world of one (bf16 steps): not bit for bit (the
# row-parallel products add their bias after the sum; the solver's norm sums
# the shards' partial dots apart), so the differences are bounded: the
# parameters' distance from default's (L2, every leaf) against how far
# default's moved (``_rel_apart``: 1 for a run that never stepped), and the
# 12 losses; each bound about 3x its reading on an H100 (1.689e-2, 7.812e-3)
MP_NORTH_REL_TOL, MP_NORTH_LOSS_TOL = 5e-2, 2e-2
MP_MOE_ARGV = ["--train_iters", "8", "--device", "cuda"]  # Switch-Base-8 widths, 4 periods
# ep against default at a world of one (fp32): the combine adds zeros to
# each token's one product, but darts' norm sums the expert shards' partial
# dots apart, so the step size eps differs in its last bits (max |param
# diff| 1.192e-7 on an H100)
MP_MOE_TOL = 5e-7
MP_SMALL_MOE = ["--dim", "16", "--hidden", "32", "--experts", "4", "--tokens", "64",
                "--val_tokens", "32", "--dense", "--train_iters", "4", "--device", "cuda"]
MP_GLOO_ARGV = SMALL_ARGV + ["--hypergradient", "sama", "--device", "cuda", "--train_iters",
                             "8"]
MP_GLOO_MESH = ["--strategy", "tp", "--mesh", "dp:1,mdl:2"]
# fp32 flash, two ranks against one process: the losses (relative), and
# the parameters' distance from one process's against how far they moved
# (``_rel_apart``; Adam's normalized step, about lr a step, takes either
# sign for an element whose gradient is within rounding of 0, so a max
# |diff| is as large as the step; the float64 runs, held to 1e-10, show the
# arithmetic is the same); on an H100 2.549e-7 and 3.622e-3
MP_FLASH_LOSS_TOL, MP_FLASH_REL_TOL = 1e-5, 1e-2
MP_F64_TOL = 1e-10


def _record_losses(engine):
    """A list that each problem step's loss is appended to, in order."""
    losses = []
    for prob in engine.problems:
        orig = prob.one_step_descent

        def record(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            losses.append(float(out["loss"]))
            return out

        prob.one_step_descent = record
    return losses


def _cast_engine(engine, dtype, moe=False):
    """The engine's states (and the MoE program's batches) in ``dtype``."""
    import torch
    from betty_tpu_torch.utils import tree_map

    engine.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    if moe:
        for prob in engine.problems:
            (x, y), = prob.train_data_loader[0]
            prob.train_data_loader[0][0] = (x.to(dtype), y)
    return engine


def _mp_engine(kind, extra=()):
    """The mp phase's small programs: ``flash`` (fp32, the flash kernels),
    ``f64`` (float64, plain attention) and ``moe`` (float64, the test's MoE
    widths)."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as bert
    from betty_tpu_torch.examples import moe_reweighting as moe

    if kind == "moe":
        return _cast_engine(moe.build_engine(moe.parse_args(MP_SMALL_MOE + list(extra))),
                            torch.float64, moe=True)
    engine = bert.build_engine(bert.parse_args(
        MP_GLOO_ARGV + (["--flash"] if kind == "flash" else []) + list(extra)))
    return engine if kind == "flash" else _cast_engine(engine, torch.float64)


def _mp_gloo2(out):
    """One of two ranks on the one card over gloo (CUDA tensors): the small
    transformer under tp at ``mdl:2`` with the fp32 flash kernels and in
    float64, and the MoE at ``ep:2`` in float64; rank 0 saves the whole
    parameters."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", backend="gloo", timeout=DIST_OP_TIMEOUT)
    reset, counters = _counters("sama")
    got = {}
    for kind, extra in (("flash", MP_GLOO_MESH), ("f64", MP_GLOO_MESH),
                        ("moe", ["--strategy", "ep", "--mesh", "dp:1,ep:2"])):
        t0 = time.time()
        engine = _mp_engine(kind, extra)
        losses = _record_losses(engine)
        reset()
        engine.run()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        got[kind] = (_whole_params(engine), losses)
        params = engine.states["inner" if kind == "moe" else "classifier"]["params"]
        held = {k: list(v.shape) for k, v in list(params.get("moe", params).items())[:5]}
        log(f"[mp gloo2 {kind}] rank {torch.distributed.get_rank()}: {time.time() - t0:.2f} s, "
            f"holds {held}, flash launches {launches}")
        if kind == "flash" and engine.device.type == "cuda":
            assert launches.get("flash_single_fwd", 0) > 0, launches
        del engine
    # pipeline and sequence parallelism: tutorial 7 small, float64
    for leg in PP_GLOO:
        for solver in ("darts", "cg"):
            t0 = time.time()
            engine = _t7(PP_GLOO[leg] + PP_SMALL[solver], dtype=torch.float64, solver=solver)
            losses = _record_losses(engine)
            engine.run()
            got[f"{leg}_{solver}"] = (_whole_params(engine), losses)
            q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
            log(f"[mp gloo2 {leg} {solver}] rank {torch.distributed.get_rank()}: "
                f"{time.time() - t0:.2f} s, holds blocks.attn.query.kernel {list(q.shape)}")
            del engine
    if torch.distributed.get_rank() == 0:
        torch.save(got, out)
    torch.distributed.barrier()


def _mp_gloo4(out):
    """One of four ranks on the one card over gloo (CUDA tensors):
    tutorial 7's program small in float64 on the composed mesh
    ``mdl:2,pp:2``, darts then CG; rank 0 saves the whole parameters."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", backend="gloo", timeout=DIST_OP_TIMEOUT)
    got = {}
    for leg in PP_GLOO4:
        for solver in ("darts", "cg"):
            t0 = time.time()
            engine = _t7(PP_GLOO4[leg] + PP_SMALL[solver], dtype=torch.float64, solver=solver)
            losses = _record_losses(engine)
            engine.run()
            got[f"{leg}_{solver}"] = (_whole_params(engine), losses)
            q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
            log(f"[mp gloo4 {leg} {solver}] rank {torch.distributed.get_rank()}: "
                f"{time.time() - t0:.2f} s, holds blocks.attn.query.kernel {list(q.shape)}")
            del engine
    if torch.distributed.get_rank() == 0:
        torch.save(got, out)
    torch.distributed.barrier()


def _mp_gloo2_check(card, gloo, out, deadline, t0, gloo4=None, out4=None):
    """The two-rank leg against this process's one-process runs."""
    import torch
    from betty_tpu_torch.utils import tree_leaves

    ref = {}
    for kind in ("flash", "f64", "moe"):
        engine = _mp_engine(kind)
        start = _whole_params(engine)
        losses = _record_losses(engine)
        engine.run()
        ref[kind] = (_whole_params(engine), start, losses)
        del engine
    for solver in ("darts", "cg"):
        engine = _t7(["--mode", "pp", "--mesh", "none"] + PP_SMALL[solver], dtype=torch.float64,
                     solver=solver)
        start = _whole_params(engine)
        losses = _record_losses(engine)
        engine.run()
        for leg in list(PP_GLOO) + list(PP_GLOO4):  # against the same one-process run
            ref[f"{leg}_{solver}"] = (_whole_params(engine), start, losses)
        del engine
    _dist_wait("[mp gloo2]", gloo, deadline)
    got = torch.load(out, weights_only=True)
    if gloo4 is not None:
        _dist_wait("[mp gloo4]", gloo4, deadline)
        got.update(torch.load(out4, weights_only=True))

    def err(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for n in a for x, y in zip(tree_leaves(a[n]), tree_leaves(b[n])))

    errs = {k: err(got[k][0], ref[k][0]) for k in ref}
    moved = {k: err(ref[k][0], ref[k][1]) for k in ref}
    rel = {k: _rel_apart(got[k][0], ref[k][0], ref[k][1])[0] for k in ref}
    dloss = {k: max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got[k][1], ref[k][2]))
             for k in ref}
    log(f"[mp gloo2] [{card}] two ranks (gloo, CUDA tensors; four for the composed mesh) "
        f"against one process: max |param "
        f"diff| {errs} (f64 and moe tol {MP_F64_TOL}); |got - one process| / |one process - "
        f"start| {rel} (flash tol {MP_FLASH_REL_TOL}); max relative loss diff {dloss} (flash "
        f"tol {MP_FLASH_LOSS_TOL}); moved from the start (max) {moved}; "
        f"{time.time() - t0:.1f} s")
    assert all(moved[k] > 0 for k in ref), moved
    f64 = [k for k in ref if k != "flash"]  # f64, moe and the pp/sp legs
    assert all(errs[k] <= MP_F64_TOL for k in f64), errs
    assert rel["flash"] <= MP_FLASH_REL_TOL, rel
    assert all(len(got[k][1]) == len(ref[k][2]) for k in ref)
    assert dloss["flash"] <= MP_FLASH_LOSS_TOL, dloss


def _mp_call_cost(n=200):
    """Host milliseconds a call of the row-parallel sum (*g* over one rank:
    a clone and an NCCL all-reduce) and of the clone alone, on the north
    star's bf16 activation [32, 128, 1024], and the device time a call."""
    import torch
    from betty_tpu_torch import parallel

    mesh = parallel.make_mesh((("dp", 1), ("mdl", 1)))
    x = torch.randn(32, 128, 1024, device="cuda", dtype=torch.bfloat16)
    out = {}
    for name, fn in (("clone", torch.clone),
                     ("g", lambda t: parallel.reduce_from_model(t, mesh))):
        for _ in range(10):
            fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        host = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        out[name] = (host, (time.perf_counter() - t0) / n * 1e3)
    log("[mp north] host ms / wall ms a call over one rank (bf16 [32, 128, 1024], "
        f"{n} calls): clone {out['clone'][0]:.4f} / {out['clone'][1]:.4f}, g (clone and "
        f"NCCL all-reduce) {out['g'][0]:.4f} / {out['g'][1]:.4f}")


def _mp_north_run(strategy, extra, calls):
    """Two north-star meta-periods under ``strategy`` and a profiled third
    (NCCL kernels and device copies, the collective calls by kind):
    ``(params, losses)``."""
    tag = f"[mp north {strategy}]"
    params, losses, periods, peak, launches, engine = _north_run(strategy, tag, extra)
    log(f"{tag} meta-period seconds {periods} (the first includes warm-up); peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    assert launches == SAMA_S128, (launches, SAMA_S128)
    assert all(math.isfinite(float(x)) for _, x in losses)
    if strategy == "tp":
        dims = engine.classifier._shard_dims["params"]
        q = engine.states["classifier"]["params"]["blocks.0.attn.query.kernel"]
        log(f"{tag} {sum(d is not None for d in dims.values())} of {len(dims)} classifier "
            f"leaves sharded over mdl (one rank: whole); query kernel held "
            f"{tuple(q.shape)} on dim {dims['blocks.0.attn.query.kernel']}")
    calls.clear()
    rep = profile_period(engine, 5, tag, classify=_nccl_kind)
    kernels = (rep or {}).get("kernels", [])
    for kind in ("nccl", "copy DtoD"):
        ks = [(t, c) for t, c, n in kernels if _nccl_kind(n) == kind]
        log(f"{tag} {kind} in the profiled period: {sum(c for _, c in ks)} launches, "
            f"{sum(t for t, _ in ks):.3f} ms device time")
    log(f"{tag} collective calls in the profiled period: {dict(calls)}")
    assert (calls.get("all_reduce", 0) > 0) or strategy == "default", calls
    del engine
    _free()
    return params, losses


def _mp_world_one(default, start, calls):
    """World of one over NCCL: the north star under tp (``dp:1,mdl:1``)
    against ``default`` (its ``(params, losses)``, both from the whole
    parameters ``start``), the MoE at Switch-Base-8's widths under ep
    (``dp:1,ep:1``) against default, compiled tp at small width against
    driver mode. Run by the dist phase's world of one after its `default`
    north star."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex
    from betty_tpu_torch.examples import moe_reweighting as moe

    pb, lb = _mp_north_run("tp", MP_TP_WORLD_ONE, calls)
    _mp_call_cost()
    pa, la = default
    same = all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in pa[n])
    dparam = max(float((pa[n][k].double() - pb[n][k].double()).abs().max())
                 for n in pa for k in pa[n])
    rel, moved = _rel_apart(pb, pa, start)
    dloss = max(abs(float(a[1]) - float(b[1])) for a, b in zip(la, lb))
    log(f"[mp north] tp vs default at a world of one: parameters bit-equal {same}, max |param "
        f"diff| {dparam:.3e}, |tp - default| / |default - start| {rel:.4e} (bound "
        f"{MP_NORTH_REL_TOL}; |default - start| {moved:.4e}), {len(la)} losses, max |loss "
        f"diff| {dloss:.3e} (bound {MP_NORTH_LOSS_TOL})")
    assert len(la) == len(lb) == 12 and all(a[0] == b[0] for a, b in zip(la, lb))
    assert moved > 0 and rel <= MP_NORTH_REL_TOL and dloss <= MP_NORTH_LOSS_TOL
    del pa, pb, default
    _free()
    # the MoE at Switch-Base-8's widths, fp32: ep over one rank against default
    moes = {}
    for strategy, extra in (("default", []), ("ep", ["--strategy", "ep", "--mesh", "dp:1,ep:1"])):
        engine = moe.build_engine(moe.parse_args(MP_MOE_ARGV + extra))
        if strategy == "default":
            moe_start = _whole_params(engine)
        torch.cuda.synchronize()
        t0 = time.time()
        engine.run()
        torch.cuda.synchronize()
        moes[strategy] = _whole_params(engine)
        log(f"[mp moe {strategy}] Switch-Base-8 widths, 8 steps {time.time() - t0:.3f} s "
            "(the first period includes warm-up)")
        del engine
    from betty_tpu_torch.utils import tree_leaves

    pairs = [(a, b) for n in moes["default"] for a, b in
             zip(tree_leaves(moes["ep"][n]), tree_leaves(moes["default"][n]))]
    same = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    rel, moved = _rel_apart(moes["ep"], moes["default"], moe_start)
    log(f"[mp moe] ep vs default at a world of one: bit-equal {same}, max |param diff| "
        f"{diff:.3e} (bound {MP_MOE_TOL}), |ep - default| / |default - start| {rel:.4e} "
        f"(|default - start| {moved:.4e})")
    assert moved > 0 and diff <= MP_MOE_TOL
    # compiled tp at small width: the period's NCCL calls captured
    argv = SMALL_ARGV + ["--hypergradient", "sama", "--flash", "--dropout", "0.1",
                         "--device", "cuda", "--strategy", "tp"] + MP_TP_WORLD_ONE
    small = {}
    for compiled in (False, True):
        engine = ex.build_engine(ex.parse_args(
            argv + ["--train_iters", "12"] + (["--compile_blocks"] if compiled else [])))
        engine.run()
        small[compiled] = _whole_params(engine)
        if compiled:
            runner = engine.block_runner
            log(f"[mp compiled] tp compiled: captures {runner.captures}, replays "
                f"{runner.replays}, periods {runner.periods_run}, capture "
                f"{runner.capture_seconds:.2f} s")
            assert runner.periods_run > 0 and runner.captures == 1
        del engine
    eq = all(torch.equal(small[True][n][k], t) for n, st in small[False].items()
             for k, t in st.items())
    log(f"[mp compiled] tp compiled vs driver at a world of one: bit-equal {eq}")
    assert eq


def mp_phase(card):
    """The two-rank leg and its one-process references, here (the world of
    one runs in the dist phase's)."""
    t0 = time.time()
    deadline = t0 + DIST_TIMEOUT
    os.makedirs("build", exist_ok=True)
    out = os.path.abspath(os.path.join("build", "mp_gloo2.pt"))
    out4 = os.path.abspath(os.path.join("build", "mp_gloo4.pt"))
    for f in (out, out4):
        if os.path.exists(f):
            os.remove(f)
    gloo = _dist_launch("mpgloo2", 2, out)
    gloo4 = _dist_launch("mpgloo4", 4, out4)
    try:
        _mp_gloo2_check(card, gloo, out, deadline, t0, gloo4, out4)
    finally:
        for p in gloo + gloo4:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[mp] [{card}] phase done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# pp: pipeline and sequence parallelism (pp, sp) over torch.distributed
# ---------------------------------------------------------------------------

# tutorial 7's program (darts, unroll 1, the MWN reweighter, AdamW 1e-4 /
# Adam 1e-4) on make_pipelined_transformer at RoBERTa-large's widths, float32,
# the global batch 32 at S128
PP_FULL = ["--vocab_size", "50265", "--seq_len", "128", "--dim", "1024", "--depth", "24",
           "--heads", "16", "--batch_size", "32"]
PP_PERIODS = 2  # darts meta-periods (one classifier and one reweight step each)
PP_MODES = {"default": ["--mode", "pp", "--mesh", "none"],
            "pp": ["--mode", "pp", "--mesh", "dp:1,pp:1", "--num_microbatches", "4"],
            "sp": ["--mode", "sp", "--mesh", "dp:1,sp:1"],
            # the dp x mdl x pp composition at a world of one: Megatron inside
            # each GPipe stage, the leaves cut on two dims (each over one rank)
            "composed": ["--mode", "pp", "--mesh", "dp:1,mdl:1,pp:1", "--num_microbatches",
                         "4"]}
# pp:1 and sp:1 against default at a world of one (fp32 steps; pp's
# 1,024-row products and sp's split sums round otherwise): the parameters'
# distance from default's against how far default's moved (``_rel_apart``),
# and the losses (relative); each bound about 4x the larger reading on an
# H100 after 4 periods (pp 2.354e-5 and 5.374e-7, sp 8.188e-6 and 1.632e-7)
PP_NORTH_REL_TOL, PP_NORTH_LOSS_TOL = 1e-4, 2e-6
# the small float64 legs: two gloo ranks (pp:2 with M 2, sp:2) and four
# (the composed mdl:2,pp:2) against one process, darts then CG
PP_SMALL = {"darts": ["--train_iters", "2"], "cg": ["--train_iters", "1"]}
PP_GLOO = {"pp": ["--mode", "pp", "--mesh", "dp:1,pp:2", "--num_microbatches", "2"],
           "sp": ["--mode", "sp", "--mesh", "dp:1,sp:2"]}
# four gloo ranks on the card: the composed mesh, the same program and check
PP_GLOO4 = {"composed": ["--mode", "pp", "--mesh", "dp:1,mdl:2,pp:2", "--num_microbatches", "2"]}


def _t7(argv, device="cuda", dtype=None, solver="darts"):
    """Tutorial 7's engine (``argv`` after ``--device``), its states cast to
    ``dtype`` if given, the classifier's hypergradient ``solver``."""
    import importlib

    t7 = importlib.import_module("betty_tpu_torch.tutorial.7_model_parallelism")
    engine = t7.build_engine(t7.parse_args(["--device", device] + list(argv)))
    if dtype is not None:
        _cast_engine(engine, dtype)
    if solver == "cg":
        engine.classifier.config.type = "cg"
        engine.classifier.config.cg_iterations = 2
    return engine


def _pp_north_run(mode, argv, start=None):
    """``PP_PERIODS`` darts meta-periods of the full-width program under
    ``mode`` (tutorial 7's ``argv``: ``PP_MODES``) and a profiled one:
    ``(params, losses, periods, peak bytes, engine, profile report,
    collective calls)``."""
    import torch
    from betty_tpu_torch.parallel import collectives

    tag = f"[pp north {mode}]"
    t0 = time.time()
    engine = _t7(PP_FULL + argv + ["--train_iters", str(PP_PERIODS)])
    torch.cuda.synchronize()
    log(f"{tag} build_engine {time.time() - t0:.1f} s")
    losses = _record_losses(engine)
    ends = []
    orig = engine.reweight.one_step_descent

    def record(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        ends.append(time.time())
        return out

    engine.reweight.one_step_descent = record
    if start is not None:
        start.update(_whole_params(engine))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    periods = [b - a for a, b in zip([t0] + ends, ends)]
    peak = torch.cuda.max_memory_allocated()
    params = _whole_params(engine)
    calls = _count_collectives(_group_labels(engine.mesh))
    collectives.CALLS.clear()
    rep = profile_period(engine, 1, tag, classify=_nccl_kind) or {}
    calls.update(collectives.CALLS)
    _restore_collectives()
    kernels = rep.get("kernels", [])
    for kind in ("nccl", "copy DtoD"):
        ks = [(t, c) for t, c, n in kernels if _nccl_kind(n) == kind]
        log(f"{tag} {kind} in the profiled period: {sum(c for _, c in ks)} launches, "
            f"{sum(t for t, _ in ks):.3f} ms device time")
    rep["nccl_ops"] = {}
    for t, c, n in kernels:
        op = _nccl_op(n)
        if op:
            prev = rep["nccl_ops"].get(op, (0, 0.0))
            rep["nccl_ops"][op] = (prev[0] + c, prev[1] + t)
    if rep["nccl_ops"]:
        log(f"{tag} NCCL kernels by collective (launches, ms): {rep['nccl_ops']}")
    log(f"{tag} meta-period seconds {[round(x, 4) for x in periods]} (the first includes "
        f"warm-up); peak {peak / 2**30:.2f} GiB; collective calls in the profiled period "
        f"{dict(calls)}")
    assert all(math.isfinite(x) for x in losses), losses
    return params, losses, periods, peak, engine, rep, dict(calls)


def _pp_world_one():
    """World of one over NCCL (the dist phase's process): tutorial 7's
    program at RoBERTa-large's widths under ``default`` (the stack run one
    block after another), ``pp:1`` (GPipe, M 4) and ``sp:1``, from one
    start; the parameters and losses against default's; then compiled
    ``pp:1`` and ``sp:1`` at small width against driver mode."""
    import torch

    start, runs = {}, {}
    for mode in ("default", "pp", "sp"):
        params, losses, periods, peak, engine, rep, calls = _pp_north_run(
            mode, PP_MODES[mode], start if mode == "default" else None)
        if mode == "pp":
            q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
            dims = engine.classifier._shard_dims["params"]
            log(f"[pp north pp] {sum(d is not None for d in dims.values())} of {len(dims)} "
                f"classifier leaves sharded over pp (one rank: whole); query kernel held "
                f"{tuple(q.shape)} on dim {dims['blocks.attn.query.kernel']}")
            # M + S - 1 = 4 ring shifts a forward
            assert calls.get("ring_shift", 0) > 0, calls
        if mode == "sp":
            assert calls.get("seq_gather", 0) > 0, calls
        runs[mode] = (params, losses)
        del engine, rep
        _free()
    pa, la = runs["default"]
    for mode in ("pp", "sp"):
        pb, lb = runs[mode]
        same = all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in pa[n])
        rel, moved = _rel_apart(pb, pa, start)
        dloss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lb, la))
        log(f"[pp north] {mode} vs default at a world of one: parameters bit-equal {same}, "
            f"|{mode} - default| / |default - start| {rel:.4e} (bound {PP_NORTH_REL_TOL}; "
            f"|default - start| {moved:.4e}), {len(la)} losses, max relative loss diff "
            f"{dloss:.3e} (bound {PP_NORTH_LOSS_TOL})")
        assert len(la) == len(lb) == 2 * (PP_PERIODS + 1)  # and the profiled period
        assert moved > 0 and rel <= PP_NORTH_REL_TOL and dloss <= PP_NORTH_LOSS_TOL
    del runs, pa, start
    _free()
    # the composed mesh small in float64 against default: the same arithmetic
    # up to the order of a few sums
    comp = {}
    for mode in ("default", "composed"):
        engine = _t7(PP_MODES[mode] + ["--train_iters", "2"], dtype=torch.float64)
        first = _whole_params(engine)
        engine.run()
        comp[mode] = (first, _whole_params(engine))
        if mode == "composed":
            q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
            dims = engine.classifier._shard_dims["params"]
            log(f"[pp composed] dp:1,mdl:1,pp:1 at a world of one: query kernel held "
                f"{tuple(q.shape)}, cut {dims['blocks.attn.query.kernel']}")
        del engine
    err = max(float((a - b).abs().max()) for n in comp["default"][1]
              for a, b in zip(comp["composed"][1][n].values(), comp["default"][1][n].values()))
    moved = max(float((a - b).abs().max()) for n in comp["default"][1]
                for a, b in zip(comp["default"][1][n].values(), comp["default"][0][n].values()))
    log(f"[pp composed] composed vs default at a world of one (float64, small): max |param "
        f"diff| {err:.3e} (tol {MP_F64_TOL}), moved {moved:.3e}")
    assert err <= MP_F64_TOL and moved > 0
    del comp
    # compiled pp:1, sp:1 and the composed mesh at small width: the ring
    # shifts, gathers and f/g captured
    for mode in ("pp", "sp", "composed"):
        small = {}
        for compiled in (False, True):
            engine = _t7(PP_MODES[mode] + ["--train_iters", "4"])
            engine.config.compile_blocks = compiled
            engine.run()
            small[compiled] = _whole_params(engine)
            if compiled:
                runner = engine.block_runner
                log(f"[pp compiled] {mode} compiled: captures {runner.captures}, replays "
                    f"{runner.replays}, periods {runner.periods_run}, capture "
                    f"{runner.capture_seconds:.2f} s")
                assert runner.periods_run > 0
                assert runner.captures == (1 if runner.on_card else 0)
            del engine
        eq = all(torch.equal(small[True][n][k], t) for n, st in small[False].items()
                 for k, t in st.items())
        log(f"[pp compiled] {mode} compiled vs driver at a world of one: bit-equal {eq}")
        assert eq


MP_FOUR_MESHES = (("dp:1,mdl:4", 32), ("dp:2,mdl:2", 16))  # (mesh, a dp rank's batch)


def _mp_four_rank(mesh, batch, out):
    """One rank of the four-card north star under tp: two meta-periods,
    then one profiled; rank 0 writes the readings."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", timeout=DIST_OP_TIMEOUT)
    calls = _count_collectives()
    argv = ["--mesh", mesh, "--batch_size", str(batch)]
    params, losses, periods, peak, launches, engine = _north_run("tp", f"[mp four {mesh}]",
                                                                 argv)
    calls.clear()
    rep = profile_period(engine, 5, f"[mp four {mesh}]", classify=_nccl_kind)
    kernels = (rep or {}).get("kernels", [])
    nccl = [(t, c) for t, c, n in kernels if _nccl_kind(n) == "nccl"]
    q = engine.states["classifier"]["params"]["blocks.0.attn.query.kernel"]
    reading = {"mesh": mesh, "rank": torch.distributed.get_rank(), "periods": periods,
               "peak_mib": peak / 2**20, "launches": launches, "calls": dict(calls),
               "nccl_launches": sum(c for _, c in nccl), "nccl_ms": sum(t for t, _ in nccl),
               "query_kernel": list(q.shape),
               "finite": all(math.isfinite(float(x)) for _, x in losses)}
    readings = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(readings, reading)
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(readings, f)
    torch.distributed.barrier()


def _mp_four_moe(out):
    """One rank of the MoE program at Switch-Base-8's widths under ``ep:4``
    (2 experts a card): 2 warm-up periods, 8 timed, one profiled; rank 0
    then runs the one-process program and compares."""
    import torch
    from betty_tpu_torch import parallel
    from betty_tpu_torch.examples import moe_reweighting as moe

    parallel.maybe_init_distributed("cuda", timeout=DIST_OP_TIMEOUT)
    calls = _count_collectives()
    argv = ["--device", "cuda", "--train_iters", "20"]
    engine = moe.build_engine(moe.parse_args(argv + ["--strategy", "ep", "--mesh", "ep:4"]))
    ends = []
    orig = engine.outer.one_step_descent

    def record(*a, **kw):
        res = orig(*a, **kw)
        torch.cuda.synchronize()
        ends.append(time.time())
        return res

    engine.outer.one_step_descent = record
    torch.cuda.reset_peak_memory_stats()
    engine.run()
    periods = [b - a for a, b in zip(ends[1:], ends[2:])]
    peak = torch.cuda.max_memory_allocated()
    calls.clear()
    rep = profile_period(engine, 2, "[mp four moe]", classify=_nccl_kind)
    nccl = [(t, c) for t, c, n in (rep or {}).get("kernels", []) if _nccl_kind(n) == "nccl"]
    got = _whole_params(engine)
    reading = {"rank": torch.distributed.get_rank(), "periods": periods, "peak_mib": peak / 2**20,
               "calls": dict(calls), "nccl_launches": sum(c for _, c in nccl),
               "nccl_ms": sum(t for t, _ in nccl),
               "w1": list(engine.states["inner"]["params"]["moe"]["w1"].shape)}
    del engine
    if torch.distributed.get_rank() == 0:
        ref = moe.build_engine(moe.parse_args(argv + ["--train_iters", "22"]))
        ref.run()
        from betty_tpu_torch.utils import tree_leaves

        want = _whole_params(ref)
        reading["max_abs_err"] = max(float((a - b).abs().max()) for n in want for a, b in
                                     zip(tree_leaves(got[n]), tree_leaves(want[n])))
    readings = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(readings, reading)
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(readings, f)
    torch.distributed.barrier()


PP_FOUR = (("pp", "dp:1,pp:4", 4), ("pp", "dp:1,pp:4", 8), ("sp", "dp:1,sp:4", None))


def _pp_four_rank(mode, mesh, M, out):
    """One rank of the four-card full-width tutorial 7 program under pp
    (``M`` microbatches) or sp: ``PP_PERIODS`` meta-periods, then one
    profiled; rank 0 writes the readings."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", timeout=DIST_OP_TIMEOUT)
    argv = ["--mode", mode, "--mesh", mesh] + (["--num_microbatches", str(M)] if M else [])
    params, losses, periods, peak, engine, rep, calls = _pp_north_run(mode, argv)
    kernels = rep.get("kernels", [])
    nccl = [(t, c) for t, c, n in kernels if _nccl_kind(n) == "nccl"]
    q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
    reading = {"mode": mode, "mesh": mesh, "M": M, "rank": torch.distributed.get_rank(),
               "periods": periods, "peak_mib": peak / 2**20, "calls": calls,
               "nccl_launches": sum(c for _, c in nccl), "nccl_ms": sum(t for t, _ in nccl),
               "busy_ms": rep.get("busy_ms"), "wall_ms": rep.get("wall_ms"),
               "query_kernel": list(q.shape), "finite": all(math.isfinite(x) for x in losses)}
    readings = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(readings, reading)
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(readings, f)
    torch.distributed.barrier()


def pp_four(card):
    """``--mp-four``'s pipeline and sequence parallel runs: tutorial 7's
    program at RoBERTa-large's widths under ``pp:4`` (6 blocks a card) at M
    4 and M 8 and under ``sp:4`` (32 positions a card), one rank a card over
    NCCL: periods, peak a card, NCCL kernels and their device time a rank
    in a profiled period."""
    for mode, mesh, M in PP_FOUR:
        tag = f"[pp four {mode} {mesh}" + (f" M{M}]" if M else "]")
        out = os.path.abspath(os.path.join("build", f"pp_four_{mode}_{M}.json"))
        procs = _dist_launch(f"ppfour:{mode}:{mesh}:{M or 0}", 4, out)
        _dist_wait(tag, procs, time.time() + DIST_TIMEOUT)
        with open(out) as f:
            readings = json.load(f)
        for r in readings:
            log(f"{tag} [{card}] rank {r['rank']}: meta-periods {r['periods']} s, peak "
                f"{r['peak_mib']:.0f} MiB, query kernel {r['query_kernel']}, NCCL "
                f"{r['nccl_launches']} launches {r['nccl_ms']:.3f} ms in the profiled period "
                f"(busy {r['busy_ms']} of {r['wall_ms']} ms), calls {r['calls']}")
        assert all(r["finite"] for r in readings)


# the composed mesh on four cards: tutorial 7's program at RoBERTa-large's
# widths (PP_FULL, fp32) on mdl:2,pp:2, M 4 (12 blocks a stage, 8 of the 16
# heads and 2,048 of the 4,096 MLP columns a card)
COMPOSED_FOUR = ["--mode", "pp", "--mesh", "dp:1,mdl:2,pp:2", "--num_microbatches", "4"]
# against one card's default from the same start after PP_PERIODS periods
# (and the profiled one): the parameters' distance from default's against
# how far default's moved (``_rel_apart``), and the losses (relative). Set
# before the first four-card run: pp:1 read 2.918e-5 and 3.003e-7 after 2
# periods (PR 20), and the row-parallel sums over two cards round the
# products otherwise again
COMPOSED_NORTH_REL_TOL, COMPOSED_NORTH_LOSS_TOL = 1e-3, 1e-4


def _composed_four_rank(out):
    """One rank of the four-card composed run: rank 0 first runs one card's
    ``default`` (the whole stack one block after another) from the same
    start, then every rank runs the program on ``mdl:2,pp:2``; rank 0
    writes the readings and the comparison."""
    import torch
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cuda", timeout=DIST_OP_TIMEOUT)
    rank = torch.distributed.get_rank()
    want = None
    if rank == 0:
        start = {}
        params, losses, periods, peak, engine, rep, _ = _pp_north_run(
            "default", PP_MODES["default"], start)
        want = {"params": params, "losses": losses, "start": start, "periods": periods,
                "peak_mib": peak / 2**20, "busy_ms": rep.get("busy_ms"),
                "wall_ms": rep.get("wall_ms"), "launches": rep.get("launches")}
        del engine, rep
        _free()
    torch.distributed.barrier()
    # rank 0's profiled period also holds the wait for the other ranks'
    # first profiler start (its own started in the default run): read busy
    # and idle on ranks 1 to 3
    params, losses, periods, peak, engine, rep, calls = _pp_north_run("composed", COMPOSED_FOUR)
    q = engine.states["classifier"]["params"]["blocks.attn.query.kernel"]
    w2 = engine.states["classifier"]["params"]["blocks.fc2.weight"]
    reading = {"rank": rank, "periods": periods, "peak_mib": peak / 2**20, "calls": calls,
               "nccl_ops": rep.get("nccl_ops", {}), "busy_ms": rep.get("busy_ms"),
               "wall_ms": rep.get("wall_ms"), "launches": rep.get("launches"),
               "query_kernel": list(q.shape), "fc2_weight": list(w2.shape),
               "finite": all(math.isfinite(x) for x in losses)}
    if rank == 0:
        rel, moved = _rel_apart(params, want["params"], want["start"])
        dloss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, want["losses"]))
        reading.update(rel=rel, moved=moved, dloss=dloss, n_losses=len(losses),
                       default={k: want[k] for k in ("periods", "peak_mib", "busy_ms",
                                                     "wall_ms", "launches")})
    del engine, params
    readings = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(readings, reading)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(readings, f)
    torch.distributed.barrier()


def composed_four(card):
    """``--mp-four``'s composed run: tutorial 7's program at RoBERTa-large's
    widths on ``mdl:2,pp:2`` (M 4), one rank a card over NCCL, held to one
    card's ``default``: periods, busy, idle, launches, peak a card, the
    collective calls by group and the NCCL kernels by collective of a
    profiled period."""
    tag = "[composed four mdl:2,pp:2 M4]"
    out = os.path.abspath(os.path.join("build", "composed_four.json"))
    if os.path.exists(out):
        os.remove(out)
    _dist_wait(tag, _dist_launch("composedfour", 4, out), time.time() + DIST_TIMEOUT)
    with open(out) as f:
        readings = json.load(f)
    d = readings[0]["default"]
    log(f"{tag} [{card}] one card's default: meta-periods {d['periods']} s, peak "
        f"{d['peak_mib']:.0f} MiB, busy {d['busy_ms']} of {d['wall_ms']} ms, {d['launches']} "
        "launches in the profiled period")
    for r in readings:
        log(f"{tag} [{card}] rank {r['rank']}: meta-periods {r['periods']} s, peak "
            f"{r['peak_mib']:.0f} MiB, query kernel {r['query_kernel']}, fc2 weight "
            f"{r['fc2_weight']}, busy {r['busy_ms']} of {r['wall_ms']} ms, {r['launches']} "
            f"launches; NCCL by collective (launches, ms) {r['nccl_ops']}; calls {r['calls']}")
    r = readings[0]
    log(f"{tag} [{card}] against one card's default: |composed - default| / |default - start| "
        f"{r['rel']:.4e} (bound {COMPOSED_NORTH_REL_TOL}; |default - start| {r['moved']:.4e}), "
        f"{r['n_losses']} losses, max relative loss diff {r['dloss']:.3e} (bound "
        f"{COMPOSED_NORTH_LOSS_TOL})")
    assert all(x["finite"] for x in readings)
    assert r["query_kernel"] == [12, 1024, 8, 64] and r["fc2_weight"] == [12, 1024, 2048], r
    assert r["moved"] > 0 and r["rel"] <= COMPOSED_NORTH_REL_TOL
    assert r["dloss"] <= COMPOSED_NORTH_LOSS_TOL


def mp_four(card):
    """``--mp-four``: the north star under tp on four cards, one rank a card
    over NCCL, at each of ``MP_FOUR_MESHES`` (the global batch 32): period,
    NCCL kernels' device time of a profiled period, peak a card; then the
    MoE at Switch-Base-8's widths under ``ep:4`` against one process."""
    import torch

    assert torch.cuda.device_count() >= 4, "--mp-four needs four cards"
    os.makedirs("build", exist_ok=True)
    out = os.path.abspath(os.path.join("build", "mp_four_moe.json"))
    _dist_wait("[mp four moe]", _dist_launch("fourmoe", 4, out), time.time() + DIST_TIMEOUT)
    with open(out) as f:
        readings = json.load(f)
    for r in readings:
        log(f"[mp four moe] [{card}] rank {r['rank']}: periods (2 steps) {r['periods']} s, peak "
            f"{r['peak_mib']:.0f} MiB, w1 {r['w1']}, NCCL {r['nccl_launches']} launches "
            f"{r['nccl_ms']:.3f} ms in the profiled period, calls {r['calls']}")
    log(f"[mp four moe] against one process (fp32, 22 steps): max |param diff| "
        f"{readings[0]['max_abs_err']:.3e} (bound {MP_MOE_TOL})")
    assert readings[0]["max_abs_err"] <= MP_MOE_TOL
    for mesh, batch in MP_FOUR_MESHES:
        out = os.path.abspath(os.path.join("build", f"mp_four_{mesh.replace(',', '_')}.json"))
        procs = _dist_launch(f"four:{mesh}:{batch}", 4, out)
        _dist_wait(f"[mp four {mesh}]", procs, time.time() + DIST_TIMEOUT)
        with open(out) as f:
            readings = json.load(f)
        for r in readings:
            log(f"[mp four {mesh}] [{card}] rank {r['rank']}: meta-periods {r['periods']} s, "
                f"peak {r['peak_mib']:.0f} MiB, query kernel {r['query_kernel']}, NCCL "
                f"{r['nccl_launches']} launches {r['nccl_ms']:.3f} ms in the profiled period, "
                f"calls {r['calls']}, flash launches {r['launches']}")
        assert all(r["finite"] for r in readings)


# the port's kernels by their own symbol names (csrc/*.cu), for the profile
KERNEL_SYMBOLS = {
    "fp32_fwd_single_kernel": "flash B1", "mma_fwd_single_kernel": "flash B1",
    "fp32_bwd_single_kernel": "flash B2", "mma_bwd_single_kernel": "flash B2",
    "fp32_fwd_kernel": "flash B3",
    "mma_fwd_kernel": "flash B3",
    "fp32_bwd_dkv_kernel": "flash B4", "fp32_bwd_dq_kernel": "flash B5",
    "mma_bwd_dkv_kernel": "flash B4", "mma_bwd_dq_kernel": "flash B5",
    "dot2_kernel": "vector (B6-B8)", "cg_step_kernel": "vector (B6-B8)",
    "neumann_step_kernel": "vector (B6-B8)", "sum_partials": "vector (B6-B8)",
}

REPLACES = {
    "flash_single_fwd": ("betty_tpu/ops/flash_attention.py:177",
                         "betty_tpu_torch/csrc/flash_single.cu"),
    "flash_single_bwd": ("betty_tpu/ops/flash_attention.py:209",
                         "betty_tpu_torch/csrc/flash_single.cu"),
    "flash_multi_fwd": ("betty_tpu/ops/flash_attention.py:373",
                        "betty_tpu_torch/csrc/flash_multi.cu"),
    "flash_multi_bwd_dkv": ("betty_tpu/ops/flash_attention.py:547",
                            "betty_tpu_torch/csrc/flash_multi.cu"),
    "flash_multi_bwd_dq": ("betty_tpu/ops/flash_attention.py:621",
                           "betty_tpu_torch/csrc/flash_multi.cu"),
    "fused_dot2": ("betty_tpu/ops/vector.py:85", "betty_tpu_torch/csrc/vector_ops.cu"),
    "cg_fused_step": ("betty_tpu/ops/vector.py:119", "betty_tpu_torch/csrc/vector_ops.cu"),
    "neumann_fused_step": ("betty_tpu/ops/vector.py:163", "betty_tpu_torch/csrc/vector_ops.cu"),
}


# the bf16 kernels that run on the tensor cores, by library
MMA_LIBS = {"flash_multi": ("mma_fwd_kernel", "mma_bwd_dkv_kernel", "mma_bwd_dq_kernel"),
            "flash_single": ("mma_fwd_single_kernel", "mma_bwd_single_kernel")}
MMA_KERNELS = tuple(k for kernels in MMA_LIBS.values() for k in kernels)
# the float32 kernels on the CUDA cores (bodies in csrc/flash_fp32.cuh), by library
FP32_LIBS = {"flash_multi": ("fp32_fwd_kernel", "fp32_bwd_dkv_kernel", "fp32_bwd_dq_kernel"),
             "flash_single": ("fp32_fwd_single_kernel", "fp32_bwd_single_kernel")}
FP32_KERNELS = tuple(k for kernels in FP32_LIBS.values() for k in kernels)
MIN_FFMA_PER_LDS = 8


def _kernel_label(symbol):
    """``name<args>`` from the mangled symbol of a kernel in a source's
    anonymous namespace, e.g. ``mma_bwd_dkv_kernel<64>`` or
    ``multi_fwd_kernel<float,64>``; the symbol itself when it is not
    one of those."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", symbol)
    pos = m.end(1) + int(m.group(1)) if m else 0  # past the namespace's name
    n = m and re.match(r"\d+", symbol[pos:])
    if not n:
        return symbol
    start = pos + n.end()
    name, rest = symbol[start:start + int(n.group())], symbol[start + int(n.group()):]
    args = []
    if rest.startswith("I"):
        for tok in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f", rest[1:rest.find("EE") + 1]):
            args.append(tok.group(1) or ("bf16" if tok.group(0).startswith("13") else "float"))
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(build_logs):
    """Each kernel's registers and spills as ``ptxas -v`` reported them in
    ``build_logs`` (``{library: nvcc output}``); raises if a tensor-core
    kernel (``MMA_KERNELS``) or a float32 kernel (``FP32_KERNELS``) spills
    at D64."""
    spilled = []
    for lib, text in build_logs.items():
        current = None
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                current = _kernel_label(m.group(1))
                continue
            if current is None:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if sp:
                log(f"[setup] ptxas {lib} {current}: {line.strip()}")
                if current.split("<")[0] in MMA_KERNELS + FP32_KERNELS and current.endswith(
                        "<64>") and (int(sp.group(1)) or int(sp.group(2))):
                    spilled.append(current)
            elif "registers" in line:
                log(f"[setup] ptxas {lib} {current}: {line.split(':', 1)[-1].strip()}")
    if spilled:
        raise AssertionError(f"kernels spill at D64: {spilled}")


SASS_INS = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _product_loops(ins):
    """The innermost loops of a kernel's SASS (``ins``: ``(address, opcode,
    operands)`` in order) that hold FFMA: ``[(first, last, FFMA, shared
    loads, of which LDS.128)]``; a loop is the span of a backward branch."""
    spans = []
    for addr, op, args in ins:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [a for a in spans if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
    loops = []
    for lo, hi in inner:
        body = [op for addr, op, _ in ins if lo <= addr <= hi]
        ffma = sum(op.split(".")[0] == "FFMA" for op in body)
        lds = sum(op.split(".")[0] == "LDS" for op in body)
        if ffma:
            loops.append((lo, hi, ffma, lds, sum(op == "LDS.128" for op in body)))
    return loops


def sass_report(lib_paths, head_dims):
    """From each built library's SASS (``cuobjdump --dump-sass``;
    ``lib_paths``: ``{library: path}``): the tensor-core instructions
    (``HMMA``) of each tensor-core kernel of ``MMA_LIBS`` at every head dim
    in ``head_dims``, which must not be 0; and the ``FFMA``, ``LDS`` (any
    width) and ``LDS.128`` instructions of each float32 kernel of
    ``FP32_LIBS`` (B1-B5), in all and in each product loop (an innermost
    loop that holds FFMA), which at D64 must do at least
    ``MIN_FFMA_PER_LDS`` FFMA per shared-memory load, with no ``HMMA`` in
    the kernel, and which must be in the SASS at every head dim."""
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             "cuobjdump"]
    tool = next((t for t in tools if os.path.isfile(t)), "cuobjdump")
    bad = []
    for lib, kernels in MMA_LIBS.items():
        out = subprocess.run([tool, "--dump-sass", str(lib_paths[lib])], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"cuobjdump failed ({out.returncode}): {out.stderr[-2000:]}")
        code, current = {}, None
        for line in out.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = _kernel_label(m.group(1))
                code[current] = []
                continue
            ins = SASS_INS.search(line) if current is not None else None
            if ins:
                code[current].append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
        for k, ins in sorted(code.items()):
            ops = [op.split(".")[0] for _, op, _ in ins]
            hmma = ops.count("HMMA")
            if k.split("<")[0] not in FP32_KERNELS:
                log(f"[setup] sass {lib} {k}: {hmma} HMMA instructions")
                continue
            n_lds128 = sum(op == "LDS.128" for _, op, _ in ins)
            log(f"[setup] sass {lib} {k}: {ops.count('FFMA')} FFMA, {ops.count('LDS')} LDS of "
                f"which {n_lds128} LDS.128, {hmma} HMMA")
            loops = _product_loops(ins)
            for lo, hi, ffma, lds, lds128 in loops:
                log(f"[setup] sass {lib} {k}:   product loop {lo:#x}-{hi:#x}: {ffma} FFMA, "
                    f"{lds} LDS of which {lds128} LDS.128 ({ffma / max(lds, 1):.2f} FFMA per "
                    "shared load)")
            if k.endswith("<64>"):
                if hmma or not loops:
                    bad.append(f"{lib} {k}: {hmma} HMMA, {len(loops)} product loops")
                bad += [f"{lib} {k}: loop {lo:#x} at {ffma / max(lds, 1):.2f} FFMA per LDS"
                        for lo, _, ffma, lds, _ in loops if ffma < MIN_FFMA_PER_LDS * lds]
        bad += [f"{lib} {kernel}<{d}>: no HMMA" for kernel in kernels for d in head_dims
                if not any(op.startswith("HMMA") for _, op, _ in code.get(f"{kernel}<{d}>", []))]
        bad += [f"{lib} {kernel}<{d}>: not in the SASS" for kernel in FP32_LIBS[lib]
                for d in head_dims if f"{kernel}<{d}>" not in code]
    if bad:
        raise AssertionError(f"kernels without the instructions of their design: {bad}")


PHASES = ("kernels", "slice", "long", "mwn", "compiled", "itd", "checkpoint", "remat", "nas",
          "robust", "programs", "pruning", "ppo", "moe", "tutorials", "dist", "mp")
# exact launch counts of the two SAMA runs over two meta-periods: per period
# 216 attention forwards and 144 backwards (5 bf16 classifier steps of 24
# layers, then SAMA's fp32 passes), one kernel each, B4 and B5 both per
# backward
SAMA_S128 = {"flash_single_fwd": 432, "flash_single_bwd": 288, "flash_multi_fwd": 0,
             "flash_multi_bwd_dkv": 0, "flash_multi_bwd_dq": 0}
SAMA_S1024 = {"flash_single_fwd": 0, "flash_single_bwd": 0, "flash_multi_fwd": 432,
              "flash_multi_bwd_dkv": 288, "flash_multi_bwd_dq": 288}


def _flash_row(name, worst, rows, launches):
    r = rows[(name, "bfloat16")]
    row = {
        "name": name, "route": "cuda", "source": REPLACES[name][1],
        "replaces": REPLACES[name][0], "launches": launches[name],
        "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "float32": {k: rows[(name, "float32")][k]
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }
    if name in ("flash_multi_bwd_dkv", "flash_multi_bwd_dq"):
        row["library_computes"] = "dq, dk and dv: the outputs of B4 and B5 together"
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="kernels (always run), slice (S128 runs), long (S1024 runs), mwn "
                         "(ResNet-32 Meta-Weight-Net), compiled (compiled blocks against "
                         "driver mode), itd (iterative differentiation and reinforce on the "
                         "MWN flagship), checkpoint (engine checkpoints and auto_resume), "
                         "remat (rematerialized encoder blocks), nas (DARTS search and its "
                         "evaluation phase), robust (robust NAS and the 4-level saliency-aware "
                         "NAS), programs (the image-captioning NAS, learning by ignoring and "
                         "implicit MAML), pruning (ImageNet data pruning: ResNet-50, EMA "
                         "teacher, device augmentation), ppo (PPO with its rollout env), moe "
                         "(the Switch MoE layer under a Meta-Weight-Net at Switch-Base-8 "
                         "widths), tutorials (test_install, the tutorials, prefetch_to_device), "
                         "dist (the data-parallel strategies over torch.distributed), mp "
                         "(tensor and expert parallelism)")
    ap.add_argument("--dist-worker", nargs=2, metavar=("MODE", "OUT"), default=None,
                    help="one rank of the dist phase (run by the dist phase itself)")
    ap.add_argument("--mp-four", action="store_true",
                    help="only the four-card runs: the composed mdl:2,pp:2 mesh, pp, sp, tp "
                         "and ep (needs four cards)")
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker(*args.dist_worker)
    phases = set(args.phases.split(",")) | {"kernels"}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        from betty_tpu_torch.ops import _build
        from betty_tpu_torch.ops import flash_attention as fa
        from betty_tpu_torch.ops import vector as vec
    except ImportError as e:
        print(f"chip_smoke: the betty_tpu_torch package is not here ({e})", file=sys.stderr)
        return 3

    card = card_line()
    log(f"[setup] card: {card}")
    if args.mp_four:
        from betty_tpu_torch.ops import _build as build

        build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        assert torch.cuda.device_count() >= 4, "--mp-four needs four cards"
        os.makedirs("build", exist_ok=True)
        composed_four(card)
        pp_four(card)
        mp_four(card)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.time()
    libs = _build.build_all()
    fa._lib("flash_single")
    fa._lib("flash_multi")
    vec._lib()
    log(f"[setup] kernels built in {time.time() - t0:.1f} s (parallel): "
        + ", ".join(f"{k} {_build.BUILD_SECONDS.get(k, 0.0):.1f} s -> {v}"
                    for k, v in libs.items()))
    ptxas_report(_build.BUILD_LOGS)
    sass_report(libs, fa.KERNEL_HEAD_DIMS)

    marks = [("kernels", time.time())]
    worst = kernel_phase()
    rows = kernel_timings()
    worst.update(multi_kernel_phase())
    rows.update(multi_kernel_timings())
    vrows = vector_phase()
    # each kernel's launches come from its own path's run
    launches = {name: None for name in REPLACES}
    if "slice" in phases:
        marks.append(("slice", time.time()))
        for hypergradient in ("sama", "cg", "neumann"):
            small_run_phase(hypergradient)
        sama = slice_phase("sama", expected=SAMA_S128)
        launches.update({k: sama[k] for k in SINGLE_KERNELS})
        launches.update(slice_phase("cg", expected={"fused_dot2": 2, "cg_fused_step": 6}))
        launches.update(slice_phase("neumann", expected={"neumann_fused_step": 6},
                                    profile=False))
    if "long" in phases:
        marks.append(("long", time.time()))
        small_run_phase("sama", seq_len=1024, batch=2)
        sama = slice_phase("sama", expected=SAMA_S1024, seq_len=1024, batch=8)
        launches.update({k: sama[k] for k in MULTI_KERNELS})
    if "mwn" in phases:
        marks.append(("mwn", time.time()))
        mwn_phase()
    if "compiled" in phases:
        marks.append(("compiled", time.time()))
        compiled_phase()
    if "itd" in phases:
        marks.append(("itd", time.time()))
        itd_phase()
    if "checkpoint" in phases:
        marks.append(("checkpoint", time.time()))
        checkpoint_phase()
    if "remat" in phases:
        marks.append(("remat", time.time()))
        remat_phase()
    if "nas" in phases:
        marks.append(("nas", time.time()))
        nas_phase(card)
    if "robust" in phases:
        marks.append(("robust", time.time()))
        robust_phase(card)
    if "programs" in phases:
        marks.append(("programs", time.time()))
        programs_phase(card)
    if "pruning" in phases:
        marks.append(("pruning", time.time()))
        pruning_phase(card)
    if "ppo" in phases:
        marks.append(("ppo", time.time()))
        ppo_phase(card)
    if "moe" in phases:
        marks.append(("moe", time.time()))
        moe_phase(card)
    if "tutorials" in phases:
        marks.append(("tutorials", time.time()))
        tutorials_phase(card)
    if "dist" in phases:
        marks.append(("dist", time.time()))
        dist_phase(card)
    if "mp" in phases:
        marks.append(("mp", time.time()))
        mp_phase(card)

    marks.append(("end", time.time()))
    log("[timing] seconds by phase: " + ", ".join(
        f"{name} {b - a:.1f}" for (name, a), (_, b) in zip(marks, marks[1:]))
        + f"; total since the build {marks[-1][1] - marks[0][1]:.1f}")
    kernels = [_flash_row(name, worst, rows, launches) for name in SINGLE_KERNELS + MULTI_KERNELS]
    for name in VECTOR_KERNELS:
        r = vrows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": REPLACES[name][1],
            "replaces": REPLACES[name][0], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **({"dot_abs_err": r["dot_abs_err"]} if "dot_abs_err" in r else {}),
            "n": N_VECTOR,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)} only: no result line")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
