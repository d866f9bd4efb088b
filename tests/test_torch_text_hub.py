"""The port's ``text`` and ``hub`` against the JAX package's, on the CPU.

Every dataset gives what the JAX dataset gives, item by item and
bitwise (the parsers and the synthetic corpora are numpy in both):
the synthetic fallbacks, and real files in the official formats written
here (an aclImdb tree, ``housing.data``, a PTB text, an ml-1m
``ratings.dat``, the conll05st-release tar of
``tests/test_dataset_parsers.py``, a tab-separated parallel corpus).
``viterbi_decode`` gives JAX's scores within 1e-5 and its paths exactly,
ties included (the first maximum). ``hub`` lists, documents and loads a
local ``hubconf.py`` and refuses a remote source.
"""

import _torch_threads  # noqa: F401

import gzip
import io
import os
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.hub as jhub
import paddle_tpu.text as jtext
import paddle_tpu_torch.hub as thub
import paddle_tpu_torch.text as ttext


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape, (i, u, v)
            np.testing.assert_array_equal(u, v)


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


@pytest.fixture
def files(tmp_path):
    """One small file a dataset in its official format."""
    imdb = tmp_path / "aclImdb"
    for mode in ("train", "test"):
        for sub, texts in (("pos", ["A great film", "loved it, truly"]),
                           ("neg", ["Boring and awful", "worst ever"])):
            d = imdb / mode / sub
            d.mkdir(parents=True)
            for i, t in enumerate(texts):
                (d / f"{i}_7.txt").write_text(t + f" {mode}")
    rng = np.random.default_rng(0)
    housing = tmp_path / "housing.data"
    np.savetxt(housing, rng.standard_normal((20, 14)) * 3 + 10, fmt="%.4f")
    ptb = tmp_path / "ptb.train.txt"
    ptb.write_text(" the cat sat on the mat \n a dog ran to the cat \n"
                   " the market rate fell \n")
    ml = tmp_path / "ml-1m"
    ml.mkdir()
    (ml / "ratings.dat").write_text("".join(
        f"{u}::{m}::{r}::97830{u}\n" for u, m, r in
        ((1, 1193, 5), (1, 661, 3), (2, 914, 3), (3, 3408, 4), (7, 2355, 5),
         (9, 1197, 3), (12, 1287, 5), (20, 2804, 5), (30, 594, 4))))
    words = "The\ncat\nsat\n\nDogs\nbark\nloudly\n\n"
    props = ("-\t(A0*\n" "-\t*)\n" "sit\t(V*)\n" "\n"
             "-\t(A0*\t(A1*\n" "bark\t(V*)\t*)\n" "loud\t*\t(V*)\n" "\n")
    conll = tmp_path / "conll05st-release.tar"
    with tarfile.open(conll, "w") as tar:
        _add(tar, "conll05st-release/test.wsj/words/test.wsj.words.gz",
             gzip.compress(words.encode()))
        _add(tar, "conll05st-release/test.wsj/props/test.wsj.props.gz",
             gzip.compress(props.encode()))
    wmt = tmp_path / "wmt.tsv"
    wmt.write_text("the cat sat\tle chat assis\nA dog ran\tun chien courait"
                   "\nno tab here\n")
    return {"imdb": str(imdb), "housing": str(housing), "ptb": str(ptb),
            "ml": str(ml), "conll": str(conll), "wmt": str(wmt)}


DATASETS = {
    "imdb_synthetic": lambda m, f: m.Imdb(mode="test", synthetic_size=40),
    "imdb_files": lambda m, f: m.Imdb(data_dir=f["imdb"], mode="train",
                                      seq_len=8),
    "synthetic_lm": lambda m, f: m.SyntheticLMDataset(
        vocab_size=64, seq_len=16, size=6, seed=3),
    "uci_synthetic": lambda m, f: m.UCIHousing(mode="test",
                                               synthetic_size=30),
    "uci_file": lambda m, f: m.UCIHousing(data_file=f["housing"],
                                          mode="train"),
    "imikolov_ngram": lambda m, f: m.Imikolov(data_file=f["ptb"],
                                              window_size=3),
    "imikolov_seq_synthetic": lambda m, f: m.Imikolov(
        data_type="SEQ", synthetic_size=20, seq_len=6),
    "movielens_files": lambda m, f: m.Movielens(data_file=f["ml"],
                                                mode="train"),
    "movielens_synthetic": lambda m, f: m.Movielens(mode="test",
                                                    synthetic_size=200),
    "conll_archive": lambda m, f: m.Conll05st(data_file=f["conll"],
                                              seq_len=8),
    "conll_synthetic": lambda m, f: m.Conll05st(seq_len=12,
                                                synthetic_size=9),
    "wmt14_file": lambda m, f: m.WMT14(data_file=f["wmt"], seq_len=6),
    "wmt16_synthetic": lambda m, f: m.WMT16(mode="test", seq_len=8,
                                            synthetic_size=12),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_datasets_match_jax_item_by_item(name, files):
    j = DATASETS[name](jtext, files)
    t = DATASETS[name](ttext, files)
    assert len(t) > 0
    _same_items(j, t)
    if hasattr(j, "vocab") and j.vocab is not None:
        assert t.vocab.itos == j.vocab.itos
    if name == "conll_archive":
        assert t.get_dict() == j.get_dict()


def test_vocab_matches_jax():
    texts = ["b a c a", "c c d", "E e e"]
    jv = jtext.Vocab.build_from_texts(texts, max_size=3, min_freq=2)
    tv = ttext.Vocab.build_from_texts(texts, max_size=3, min_freq=2)
    assert tv.itos == jv.itos and tv.stoi == jv.stoi
    toks = ["a", "zz", "e"]
    assert tv.encode(toks) == jv.encode(toks)
    assert tv.decode([0, 5, 99, -1]) == jv.decode([0, 5, 99, -1])


@pytest.mark.parametrize("case", ["random", "ties", "one_step"])
def test_viterbi_decode_matches_jax(case):
    """Scores within 1e-5, paths exact; integer potentials tie often
    (both take the first maximum). float32 scores and int32 paths."""
    rng = np.random.default_rng({"random": 0, "ties": 1,
                                 "one_step": 2}[case])
    b, t, n = {"random": (4, 9, 5), "ties": (6, 7, 4),
               "one_step": (3, 1, 6)}[case]
    if case == "ties":
        pot = rng.integers(0, 2, (b, t, n)).astype(np.float32)
        trans = np.zeros((n, n), np.float32)
    else:
        pot = rng.standard_normal((b, t, n)).astype(np.float32)
        trans = rng.standard_normal((n, n)).astype(np.float32)
    js, jp = jtext.viterbi_decode(pot, trans)
    ts, tp = ttext.viterbi_decode(torch.from_numpy(pot),
                                  torch.from_numpy(trans))
    assert ts.dtype == torch.float32 and tp.dtype == torch.int32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # arrays go to the expected place, as the tensors do
    from paddle_tpu_torch.core import place
    place.set_device("cpu")
    try:
        s2, p2 = ttext.viterbi_decode(pot, trans)
    finally:
        place.reset_device()
    assert torch.equal(s2, ts) and torch.equal(p2, tp)


HUBCONF = '''
dependencies = ["numpy"]


def tiny_mlp(width=4):
    """A tiny MLP entrypoint."""
    return {"width": width}


def _private():
    return None
'''


@pytest.mark.parametrize("side", ["jax", "port"])
def test_hub_local_hubconf(side, tmp_path):
    hub = jhub if side == "jax" else thub
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert hub.list(repo, source="local") == ["tiny_mlp"]
    assert hub.help(repo, "tiny_mlp", source="local") == \
        "A tiny MLP entrypoint."
    assert hub.load(repo, "tiny_mlp", source="local", width=7) == \
        {"width": 7}
    with pytest.raises(ValueError, match="no entrypoint"):
        hub.load(repo, "missing", source="local")
    with pytest.raises(RuntimeError, match="source='local'"):
        hub.list(repo, source="github")
    (tmp_path / "hubconf.py").write_text(
        'dependencies = ["no_such_module_xyz"]\n')
    with pytest.raises(RuntimeError, match="no_such_module_xyz"):
        hub.list(repo, source="local")
    if side == "port":
        import sys
        assert "paddle_tpu_torch_hubconf" in sys.modules
    os.remove(tmp_path / "hubconf.py")
    with pytest.raises(FileNotFoundError):
        hub.list(repo, source="local")
