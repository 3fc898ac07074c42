"""The Meta-Weight-Net example of the JAX package and the port's, run in
float64 from the same weights on the same batches: a 3-block ResNet
(stage sizes 1/1/1, substituted for ResNet-32 on both sides here), batch 8.
After 4 classifier and 4 reweight steps (unroll 1) both problems' params
and batch_stats must agree within TOL. The ``itd`` case is the program
differentiated through the classifier's SGD step: the classifier an
``IterativeProblem`` carrying the example's ``Classifier.training_step``,
the reweighter ``first_order=False``, built on either side from the
example's engine (``itd_variant``).

Run as a subprocess by test_torch_mwn.py (float64 JAX must not leak into
the float32 test process). float64, because in float32 a ReLU whose input
lies within rounding of 0 takes another branch in either framework and
changes that step's gradient discontinuously (ROADMAP.md §C).

    python tests/torch_mwn_impl.py darts cg baseline
"""

import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from betty_tpu.models import ResNet as JResNet  # noqa: E402
from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.examples import learning_to_reweight as tex  # noqa: E402
from betty_tpu_torch.utils import tree_map  # noqa: E402

TOL = 1e-8  # measured: 3.4e-10 after 4 + 4 steps
ARGV = ["--batch_size", "8", "--train_size", "64", "--meta_size", "32", "--train_iters", "4"]
CASES = {
    "darts": ["--solver", "darts"],
    "sama": ["--solver", "sama"],
    "cg": ["--solver", "cg"],
    "neumann": ["--solver", "neumann", "--neumann_iterations", "3"],
    "baseline": ["--baseline"],
    "retrain": ["--retrain"],
    "itd": ["--solver", "darts"],
}


def jax_example():
    spec = importlib.util.spec_from_file_location(
        "mwn_torch_parity", ROOT / "examples" / "learning_to_reweight" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mwn_torch_parity"] = mod
    spec.loader.exec_module(mod)
    mod.ResNet32 = lambda n: JResNet(stage_sizes=(1, 1, 1), num_classes=n)
    return mod


def _f64_jax(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _f64_loaders(problems):
    for p in problems:
        loaders = p.train_data_loader
        for dl in (loaders if isinstance(loaders, (list, tuple)) else [loaders]):
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])


def itd_variant(engine, pkg, engine_cls, classifier_cls, reweight_cls, **kw):
    """``engine`` rebuilt from its own pieces with the classifier an
    ``IterativeProblem`` carrying ``classifier_cls.training_step`` and the
    reweighter ``first_order=False`` (``pkg``: betty_tpu or the port)."""
    import dataclasses

    class ITDClassifier(pkg.IterativeProblem):
        training_step = classifier_cls.training_step

    clf, rw = engine.classifier, engine.reweight
    classifier = ITDClassifier(name="classifier", module=clf.module_fn, optimizer=clf.optimizer,
                               train_data_loader=clf.train_data_loader[0], config=clf.config)
    reweight = reweight_cls(name="reweight", module=rw.module_fn, optimizer=rw.optimizer,
                            train_data_loader=rw.train_data_loader[0],
                            config=dataclasses.replace(rw.config, first_order=False))
    return engine_cls(config=engine.config, problems=[reweight, classifier],
                      dependencies={"u2l": {reweight: [classifier]},
                                    "l2u": {classifier: [reweight]}}, **kw)


def resnet_state(jstate):
    return convert.from_flax_resnet(
        jax.tree_util.tree_map(np.asarray, {"params": jstate["params"],
                                            "batch_stats": jstate["extra"]["batch_stats"]}),
        dtype=torch.float64)


def run_case(jmod, case, workdir):
    argv = ARGV + CASES[case]
    if case == "retrain":
        rng = np.random.RandomState(3)
        path = os.path.join(workdir, "reweight.npz")
        np.savez(path, weights=rng.rand(48), indexes=rng.permutation(64)[:48],
                 labels=rng.randint(0, 10, 48).astype(np.int32))
        argv += ["--reweight_path", path]
    jeng = jmod.build_engine(jmod.parse_args(argv))
    teng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu", "--stage_sizes", "1,1,1"]))
    if case == "itd":
        import betty_tpu
        import betty_tpu_torch

        jeng = itd_variant(jeng, betty_tpu, jmod.MWNEngine, jmod.Classifier, jmod.Reweight)
        teng = itd_variant(teng, betty_tpu_torch, tex.MWNEngine, tex.Classifier, tex.Reweight,
                           device="cpu")
    jeng.states = _f64_jax(jeng.states)
    _f64_loaders(jeng.problems)
    teng.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                           else t, teng.states)
    _f64_loaders(teng.problems)
    params, stats = resnet_state(jeng.states["classifier"])
    teng.states["classifier"]["params"] = params
    teng.states["classifier"]["extra"] = {"batch_stats": stats}
    if "reweight" in jeng.states:
        teng.states["reweight"]["params"] = convert.from_flax_mwn(
            jax.tree_util.tree_map(np.asarray, jeng.states["reweight"]["params"]),
            dtype=torch.float64)
    init = {k: t.clone() for k, t in {**params, **stats}.items()}

    jeng.run()
    teng.run()
    counts = {p.name: p.count for p in teng.problems}
    assert counts == {p.name: p.count for p in jeng.problems}, counts
    assert all(c == 4 for c in counts.values()), counts

    params, stats = resnet_state(jeng.states["classifier"])
    got = teng.states["classifier"]
    errs = {"params": max(float((got["params"][k] - t).abs().max()) for k, t in params.items()),
            "batch_stats": max(float((got["extra"]["batch_stats"][k] - t).abs().max())
                               for k, t in stats.items())}
    assert set(got["params"]) == set(params) and set(got["extra"]["batch_stats"]) == set(stats)
    moved = min(max(float((params[k] - init[k]).abs().max()) for k in params),
                max(float((stats[k] - init[k]).abs().max()) for k in stats))
    if "reweight" in jeng.states:
        want = convert.from_flax_mwn(
            jax.tree_util.tree_map(np.asarray, jeng.states["reweight"]["params"]),
            dtype=torch.float64)
        errs["reweight"] = max(float((teng.states["reweight"]["params"][k] - t).abs().max())
                               for k, t in want.items())
    return errs, moved


def main(cases):
    jmod = jax_example()
    failed = []
    with tempfile.TemporaryDirectory() as workdir:
        for case in cases:
            errs, moved = run_case(jmod, case, workdir)
            ok = max(errs.values()) <= TOL and moved > 0
            print(("OK " if ok else "FAIL ") + json.dumps({"case": case, "max_abs_err": errs,
                                                         "moved": moved}), flush=True)
            if not ok:
                failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
