"""The real-data entry of the port's examples (``--data-dir``) against the
JAX examples, on files the tests write.

* SST-2 (``examples/bert_data_reweighting.py``): ``hashed_tokenize``,
  ``load_sst2`` (TSV directories in either column order, with and without
  headers, an npz of token ids, a ``tokenizer/`` directory that does not
  load and one that does) and ``split_imbalanced`` give the JAX example's
  arrays and indices bit for bit; the small run mirrors
  ``tests/test_examples.py::test_bert_reweighting_real_data_path``
  (long-tail classes, a balanced meta set, dev accuracy and the best
  checkpoint), also with the data on the device, compiled against driver
  mode and under dp at two gloo ranks.
* CIFAR-10 (a pickle directory and an npz) through the DARTS search, its
  evaluation phase and robust NAS, and a feature npz through SANAS: the
  loaders' arrays equal those of the JAX examples' ``build_engine``, the
  first augmented and cutout evaluation batches too; ``num_classes``,
  ``dim`` and ``classes`` come from the data; ``validation()`` reports
  ``test_acc`` or ``masked_acc``.
* The command lines: every flag of the JAX examples' parsers is in the
  port with JAX's default, except exactly ``--hf_model`` and
  ``--rng_impl`` (``--donate`` is held like every other flag).
"""

import argparse
import importlib
import importlib.util
import itertools
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu_torch.examples import bert_data_reweighting as tbert
from betty_tpu_torch.examples import nas_eval as teval
from betty_tpu_torch.examples import neural_architecture_search as tsearch
from betty_tpu_torch.examples import robust_nas as trobust
from betty_tpu_torch.examples import saliency_aware_nas_4_level as tsanas
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# the JAX flags the port leaves out: a HuggingFace Flax checkpoint and JAX's
# PRNG implementation
LEFT_OUT = {"hf_model", "rng_impl"}
BERT_SMALL = ["--device", "cpu", "--model", "small", "--train_iters", "6", "--batch_size", "8",
              "--seq_len", "16", "--dim", "32", "--depth", "1", "--heads", "2",
              "--unroll_steps", "2", "--num_meta", "40", "--imbalance", "5",
              "--precision", "fp32"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _jax_example(rel):
    """A JAX example's module, loaded from its file. The vision examples
    import ``main`` (learning_to_reweight's) by name, so a stray ``main``
    module is dropped first."""
    stray = sys.modules.get("main")
    if stray is not None and "learning_to_reweight" not in str(getattr(stray, "__file__", "")):
        del sys.modules["main"]
    name = "data_dir_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbert():
    return _jax_example("bert_data_reweighting/main.py")


# ---------------------------------------------------------------------------
# SST-2
# ---------------------------------------------------------------------------

WORDS = ["good", "bad", "Great", "awful,", "fine.", "poor", "n't", "café", "movie", "plot",
         "--", "A", "the", "of", "it's", "(sad)"]


def _sentences(rng, n, longest=14):
    return [" ".join(rng.choice(WORDS, size=rng.randint(0, longest))) for _ in range(n)]


def _write_tsv(path, sentences, labels, order="label", header=False, junk=0):
    with open(path, "w") as f:
        if header:
            f.write("label\tsentence\n" if order == "label" else "sentence\tlabel\n")
        for i, (s, y) in enumerate(zip(sentences, labels)):
            f.write(f"{y}\t{s}\n" if order == "label" else f"{s}\t{y}\n")
            if i < junk:
                f.write("a row without a tab\n")


def write_sst2(root, n_train=400, n_dev=64, train_order="label", dev_order="label",
               header=False, seed=0):
    """A GLUE-style SST-2 directory of seeded sentences: ``train.tsv`` and
    ``dev.tsv`` with the label first or last, optional headers, and a few
    rows without a tab."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for name, n, order in (("train.tsv", n_train, train_order), ("dev.tsv", n_dev, dev_order)):
        _write_tsv(root / name, _sentences(rng, n), rng.randint(0, 2, n), order, header, junk=3)
    return root


def _hf_tokenizer(path):
    """A word-level HuggingFace tokenizer saved at ``path`` (no download)."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[CLS]": 1, "[UNK]": 2}
    vocab.update({w: i + 3 for i, w in enumerate(["good", "bad", "movie", "plot", "the"])})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", cls_token="[CLS]",
                            unk_token="[UNK]").save_pretrained(str(path))


def test_hashed_tokenize_matches_jax(jbert):
    rng = np.random.RandomState(3)
    sents = _sentences(rng, 50, longest=30) + ["", "  spaced   out\twords ", "UPPER lower"]
    for vocab, seq_len in ((1000, 8), (50265, 128), (7, 4)):
        got = tbert.hashed_tokenize(sents, vocab, seq_len)
        want = jbert.hashed_tokenize(sents, vocab, seq_len)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert (got[:, 0] == 1).all() and got[len(sents) - 3, 1:].sum() == 0


SST2_LAYOUTS = {
    "label first": dict(),
    "GLUE order, headers": dict(train_order="sentence", dev_order="sentence", header=True),
    "mixed orders": dict(train_order="sentence", dev_order="label", header=True),
}


@pytest.mark.parametrize("layout", list(SST2_LAYOUTS) + ["npz", "tokenizer that does not load",
                                                         "huggingface tokenizer"])
def test_load_sst2_matches_jax(jbert, tmp_path, layout):
    vocab, seq_len = 200, 8
    if layout == "npz":
        rng = np.random.RandomState(1)
        path = tmp_path / "sst2.npz"
        np.savez(path, x_train=rng.randint(0, vocab, (40, seq_len)), y_train=rng.randint(0, 2, 40),
                 x_dev=rng.randint(0, vocab, (9, seq_len)), y_dev=rng.randint(0, 2, 9))
        path = str(path)
    else:
        path = write_sst2(tmp_path / "sst2", **SST2_LAYOUTS.get(layout, {}))
        if layout == "tokenizer that does not load":
            (path / "tokenizer").mkdir()
            (path / "tokenizer" / "config.json").write_text("not a tokenizer")
        elif layout == "huggingface tokenizer":
            _hf_tokenizer(path / "tokenizer")
        path = str(path)
    got = tbert.load_sst2(path, vocab, seq_len)
    want = jbert.load_sst2(path, vocab, seq_len)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    if layout != "npz":
        assert len(got[1]) == 400 and len(got[3]) == 64 and got[0].shape == (400, seq_len)
        name, _ = tbert.sst2_tokenizer(path, vocab, seq_len)
        assert name.startswith("huggingface") == (layout == "huggingface tokenizer"), name
        if layout == "huggingface tokenizer":
            assert got[0].max() < 8  # the word-level vocabulary's ids
            assert not np.array_equal(got[0], tbert.hashed_tokenize(
                tbert._read_tsv(os.path.join(path, "train.tsv"))[0], vocab, seq_len))


def test_load_sst2_without_parseable_rows_raises_as_jax(jbert, tmp_path):
    for name in ("train.tsv", "dev.tsv"):
        (tmp_path / name).write_text("sentence\tlabel\nno labels anywhere\n")
    with pytest.raises(ValueError, match="no parseable rows") as got:
        tbert.load_sst2(str(tmp_path), 200, 8)
    with pytest.raises(ValueError) as want:
        jbert.load_sst2(str(tmp_path), 200, 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n, positive, imbalance, num_meta", [
    (400, 0.5, 5, 40),
    (1000, 0.56, 10, 200),   # SST-2's class balance
    (120, 0.2, 2, 40),       # the minority truncated to what is left after the meta set
    (90, 0.8, 3, 20),        # the majority class is class 1
    (61, 0.5, 1.5, 7),       # odd sizes, a fractional factor
])
def test_split_imbalanced_matches_jax(jbert, n, positive, imbalance, num_meta):
    y = (np.random.RandomState(n).rand(n) < positive).astype(np.int32)
    rows = np.arange(n)  # the split's x is the rows it chose
    got = tbert.split_imbalanced(rows, y, imbalance, num_meta_total=num_meta)
    want = jbert.split_imbalanced(rows, y, imbalance, num_meta_total=num_meta)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    train, meta = got[0], got[2]
    assert not set(train) & set(meta)
    assert np.bincount(got[3], minlength=2).tolist() == [min(num_meta // 2, int((y == c).sum()))
                                                         for c in (0, 1)]


def _bert_arrays(engine):
    return [np.asarray(torch.as_tensor(a).cpu()) for p in (engine.classifier, engine.reweight)
            for a in p.train_data_loader[0].arrays]


@pytest.mark.parametrize("extra", [["--flash"], ["--device_data"]])
def test_small_bert_run_from_data_dir(jbert, tmp_path, extra):
    """``tests/test_examples.py``'s real-data run in the port: the hashed
    tokenizer, a long tail, a balanced meta set, dev accuracy and the best
    checkpoint; the loaders hold the JAX example's split."""
    data = write_sst2(tmp_path / "sst2")
    argv = BERT_SMALL + ["--data-dir", str(data), "--valid_step", "4",
                         "--checkpoint_dir", str(tmp_path / "ckpt")] + extra
    engine = tbert.build_engine(tbert.parse_args(argv))
    assert engine.tokenizer == "hashed"
    x_tr, y_tr, x_me, y_me = _bert_arrays(engine)
    c = np.bincount(y_tr, minlength=2)
    assert c[0] >= 2 * c[1] >= 2
    assert np.bincount(y_me, minlength=2).tolist() == [20, 20]
    x_all, y_all, x_dev, y_dev = jbert.load_sst2(str(data), 1000, 16)
    want = jbert.split_imbalanced(x_all, y_all, 5, num_meta_total=40)
    for a, b in zip((x_tr, y_tr, x_me, y_me), want):
        assert np.array_equal(a, b)
    assert np.array_equal(engine.dev_data[0], x_dev) and np.array_equal(engine.dev_data[1], y_dev)
    # the data's dtype is the synthetic path's, on the host or the device
    synthetic = tbert.build_engine(tbert.parse_args(BERT_SMALL + extra))
    for a, b in zip(engine.classifier.train_data_loader[0].arrays,
                    synthetic.classifier.train_data_loader[0].arrays):
        assert type(a) is type(b) and a.dtype == b.dtype
    engine.run()
    assert engine.classifier.count == 6 and engine.reweight.count == 3
    assert 0 < engine.best_acc <= 100
    assert (tmp_path / "ckpt" / "meta.json").exists()


def test_bert_data_dir_compiled_equals_driver(tmp_path):
    """``--compile_blocks`` on the real-data loaders (on the device) gives
    driver mode's states bit for bit."""
    data = write_sst2(tmp_path / "sst2")
    argv = BERT_SMALL + ["--data-dir", str(data), "--train_iters", "8", "--flash",
                         "--device_data", "--valid_step", "100"]
    driver = tbert.build_engine(tbert.parse_args(argv))
    driver.run()
    compiled = tbert.build_engine(tbert.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.periods_run >= 2
    assert compiled.classifier.count == driver.classifier.count == 8
    equal_trees(driver.states, compiled.states)


_RANK = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from betty_tpu_torch.examples import bert_data_reweighting as ex
engine = ex.build_engine(ex.parse_args(sys.argv[1:]))
engine.run()
loader = engine.classifier.train_data_loader[0]
print("RESULT " + json.dumps({
    "y": np.asarray(loader.arrays[1]).tolist(), "best_acc": engine.best_acc,
    "params": {k: t.double().sum().item()
               for k, t in engine.states["classifier"]["params"].items()},
}))
"""


def test_bert_data_dir_under_dp_at_two_ranks(tmp_path):
    """Two gloo ranks under ``--strategy dp``: each loads the same split and
    keeps its half of the rows (``shard_loader``), and the replicas agree."""
    import socket

    data = write_sst2(tmp_path / "sst2")
    argv = BERT_SMALL + ["--data-dir", str(data), "--valid_step", "6", "--strategy", "dp",
                         "--dropout", "0.0", "--batch_size", "4"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2", PYTHONPATH=str(ROOT))
    for k in ("BETTY_COORDINATOR_ADDRESS", "BETTY_NUM_PROCESSES", "BETTY_PROCESS_ID",
              "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK] + argv, cwd=tmp_path,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    res = [json.loads([ln for ln in o.splitlines() if ln.startswith("RESULT ")][-1][7:])
           for o in outs]
    one = tbert.build_engine(tbert.parse_args(argv[:argv.index("--strategy")]))
    y = np.asarray(one.classifier.train_data_loader[0].arrays[1])
    for r in range(2):
        assert res[r]["y"] == y[r::2].tolist()
    assert res[0]["params"] == res[1]["params"]
    assert res[0]["best_acc"] == res[1]["best_acc"] and 0 < res[0]["best_acc"] <= 100


# ---------------------------------------------------------------------------
# CIFAR-10 and the feature npz of the NAS examples
# ---------------------------------------------------------------------------

def write_cifar(root, layout, per_batch=8, n_test=8, classes=7, seed=0):
    """A CIFAR-10 copy of seeded uint8 images: the pickle directory
    (``cifar-10-batches-py/data_batch_1..5, test_batch``) or an npz;
    labels below ``classes``."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)

    def images(n):
        return rng.randint(0, 256, (n, 3 * 32 * 32)).astype(np.uint8)

    if layout == "npz":
        path = root / "cifar10.npz"
        np.savez(path, x_train=images(5 * per_batch).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                 y_train=rng.randint(0, classes, 5 * per_batch),
                 x_test=images(n_test).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                 y_test=rng.randint(0, classes, n_test))
        return str(path)
    sub = root / "cifar-10-batches-py"
    sub.mkdir()
    names = [(f"data_batch_{i}", per_batch) for i in range(1, 6)] + [("test_batch", n_test)]
    for name, n in names:
        with open(sub / name, "wb") as f:
            pickle.dump({b"data": images(n), b"labels": list(rng.randint(0, classes, n))}, f)
    return str(root)


def _loader_arrays(engine):
    out = []
    for p in engine.problems:
        for dl in p.train_data_loader:
            out.extend(np.asarray(a) for a in dl.arrays)
    return out


def _same(got, want):
    """Equal arrays: images bit for bit in their dtype, labels by value
    (the port's labels are int64 for ``cross_entropy``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype
    assert np.array_equal(got, want)


VISION = {
    "search": ("neural_architecture_search/main.py", tsearch,
               ["--channels", "2", "--layers", "1", "--batch_size", "4", "--train_iters", "2",
                "--valid_step", "1000"]),
    "eval": ("neural_architecture_search/train.py", teval,
             ["--init_channels", "4", "--layers", "2", "--batch_size", "4", "--epochs", "1",
              "--auxiliary", "--cutout", "--cutout_length", "8"]),
    "robust": ("robust_nas/main.py", trobust,
               ["--arch", "mlp", "--batch_size", "4", "--train_iters", "2", "--valid_step",
                "1000"]),
}


def _namespace(mod_port, argv):
    """The JAX robust example parses in its ``__main__`` block, so its
    ``build_engine`` takes the port's namespace less the port's own flags."""
    args = vars(mod_port.parse_args(argv))
    for k in ("device", "compile_blocks", "checkpoint_dir", "checkpoint_step"):
        args.pop(k, None)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("layout", ["pickle", "npz"])
@pytest.mark.parametrize("example", list(VISION))
def test_vision_data_dir_matches_jax(tmp_path, example, layout):
    rel, tmod, argv = VISION[example]
    path = write_cifar(tmp_path / "cifar", layout)
    argv = argv + ["--data-dir", path]
    jmod = _jax_example(rel)
    jeng = jmod.build_engine(_namespace(tmod, argv) if example == "robust"
                             else jmod.parse_args(argv))
    teng = tmod.build_engine(tmod.parse_args(argv + ["--device", "cpu"]))
    got, want = _loader_arrays(teng), _loader_arrays(jeng)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)
    for a, b in zip(teng.test_data, jeng.test_data):
        _same(a, b)
    assert len(teng.test_data[1]) == 8
    if example == "eval":
        # the classes counted from the labels (7), the heads sized to them
        import jax

        heads = {t.shape[0] for t in teng.states["network"]["params"].values() if t.ndim == 2}
        jheads = {np.shape(t)[-1] for t in jax.tree_util.tree_leaves(jeng.states["network"]
                                                                      ["params"])
                  if np.ndim(t) == 2}
        assert heads == jheads == {int(np.asarray(want[1]).max()) + 1} == {7}
        # the first batches: cropped, flipped and cut out on the host, and
        # the drop-path probability appended
        ours, theirs = teng.network.train_data_loader[0], jeng.network.train_data_loader[0]
        assert ours.augment and theirs.augment and not ours.postprocess_is_identity
        for (gx, gy, gdp), (wx, wy, wdp) in itertools.islice(zip(ours, theirs), 3):
            _same(gx, wx)
            _same(gy, wy)
            assert gdp == wdp
    else:
        # the arch's rows are the train set's second half, not augmented
        assert len(got[0]) == len(got[2]) == 20
        assert not teng.classifier.train_data_loader[0].augment
    teng.run()
    teng.eval()
    stats = teng.validation()
    assert 0.0 <= stats["test_acc"] <= 100.0, stats


def test_nas_eval_augmented_batches_compiled_equals_driver(tmp_path):
    """Compiled blocks take the host's augmented batches (crop, flip,
    cutout and the drop-path scalar copied into the graph's inputs each
    step): the states equal driver mode's bit for bit."""
    argv = VISION["eval"][2] + ["--data-dir", write_cifar(tmp_path, "pickle"), "--device", "cpu"]
    driver = teval.build_engine(teval.parse_args(argv))
    driver.train_iters = 4
    driver.run()
    compiled = teval.build_engine(teval.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.train_iters = 4
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.periods_run >= 2
    assert compiled.network.count == driver.network.count == 4
    equal_trees(driver.states, compiled.states)


@pytest.mark.parametrize("layout", ["cifar npz", "feature npz"])
def test_sanas_feature_npz_matches_jax(tmp_path, layout):
    if layout == "cifar npz":
        path = write_cifar(tmp_path, "npz", per_batch=40)  # 200 rows of 3072 features
        dim, classes = 3072, 7
    else:
        rng = np.random.RandomState(4)
        path = str(tmp_path / "features.npz")
        np.savez(path, x_train=rng.randn(301, 12).astype(np.float64),
                 y_train=rng.randint(0, 4, 301).astype(np.int32))
        dim, classes = 12, 4
    argv = ["--batch", "16", "--train_iters", "8", "--valid_step", "4", "--data-dir", path]
    jmod = _jax_example("saliency_aware_nas_4_level/main.py")
    jargs = _namespace(tsanas, argv)
    jeng = jmod.build_engine(jargs)
    targs = tsanas.parse_args(argv + ["--device", "cpu"])
    teng = tsanas.build_engine(targs)
    assert (targs.dim, targs.classes) == (jargs.dim, jargs.classes) == (dim, classes)
    assert teng.states["outer"]["params"]["mask"].shape == (dim,)
    for tp, jp in zip(teng.problems, jeng.problems):
        ours, theirs = tp.train_data_loader[0], jp.train_data_loader[0]
        assert tp.name == jp.name and len(ours) == len(theirs) > 0
        for (gx, gy), (wx, wy) in zip(ours, theirs):
            _same(gx, wx)
            _same(gy, wy)
    for a, b in zip(teng.test_data, jeng.test_data):
        _same(a, b)
    teng.run()
    assert [p.count for p in teng.problems] == [2, 4, 8]
    teng.eval()
    assert 0.0 <= teng.validation()["masked_acc"] <= 100.0


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

PARSERS = {
    "bert_data_reweighting/main.py": "bert_data_reweighting",
    "imagenet_pruning/main.py": "imagenet_pruning",
    "implicit_maml/main.py": "implicit_maml",
    "learning_by_ignoring/main.py": "learning_by_ignoring",
    "learning_to_reweight/main.py": "learning_to_reweight",
    "logistic_regression_hpo/main.py": "logistic_regression_hpo",
    "nas_augmented_image_captioning_3_level/main.py": "nas_augmented_image_captioning_3_level",
    "neural_architecture_search/main.py": "neural_architecture_search",
    "neural_architecture_search/train.py": "nas_eval",
    "ppo/main.py": "ppo",
    "robust_nas/main.py": "robust_nas",
    "saliency_aware_nas_4_level/main.py": "saliency_aware_nas_4_level",
}


@pytest.fixture(scope="module")
def jax_defaults():
    """Every JAX example's command-line defaults, read side by side."""
    with ThreadPoolExecutor(4) as pool:
        out = pool.map(lambda rel: jax_cli_defaults(EXAMPLES / rel), PARSERS)
        return dict(zip(PARSERS, out))


def test_bert_cli_defaults_are_the_jax_example(jax_defaults):
    """The north star's flags: JAX's, with its defaults (``--donate`` off),
    less exactly the two left out; the port adds ``--device`` (cuda)."""
    ours = vars(tbert.parse_args([]))
    theirs = jax_defaults["bert_data_reweighting/main.py"]
    assert set(theirs) - set(ours) == LEFT_OUT
    assert {k: ours[k] for k in theirs if k not in LEFT_OUT} == \
        {k: v for k, v in theirs.items() if k not in LEFT_OUT}
    assert set(ours) - set(theirs) == {"device"} and ours["device"] == "cuda"
    assert ours["data_dir"] is None and ours["num_meta"] == 200 and ours["donate"] is False


@pytest.mark.parametrize("rel", list(PARSERS))
def test_every_jax_flag_is_ported(jax_defaults, rel):
    ours = vars(importlib.import_module(f"betty_tpu_torch.examples.{PARSERS[rel]}")
                .parse_args([]))
    theirs = jax_defaults[rel]
    assert set(theirs) - set(ours) <= LEFT_OUT, set(theirs) - set(ours)
    assert {k: ours[k] for k in theirs if k in ours} == \
        {k: v for k, v in theirs.items() if k in ours}
    assert ours["device"] == "cuda"


def test_the_flags_left_out_are_exactly_three(jax_defaults):
    """Over every example, the JAX flags the port lacks are exactly
    ``LEFT_OUT``: ``--hf_model`` and ``--rng_impl`` (``--donate`` was the
    third until ``donate_state`` was ported)."""
    missing = set()
    for rel, theirs in jax_defaults.items():
        ours = vars(importlib.import_module(f"betty_tpu_torch.examples.{PARSERS[rel]}")
                    .parse_args([]))
        missing |= set(theirs) - set(ours)
    assert missing == LEFT_OUT
