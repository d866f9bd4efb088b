"""Text datasets and utilities (port of ``paddle_tpu/text/__init__.py``;
reference parity: ``python/paddle/text/``: Imdb / WMT-style datasets and
a simple vocab / tokenizer).

The datasets read local files only, or serve the JAX package's
deterministic synthetic corpora; the parsers and the synthetic draws
are numpy and give what the JAX package gives, item by item.
:func:`viterbi_decode` runs on the tensors' device.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..io.dataset import Dataset


class Vocab:
    def __init__(self, counter: Counter, max_size: Optional[int] = None,
                 min_freq: int = 1,
                 specials=("<pad>", "<unk>", "<bos>", "<eos>")):
        self.itos: List[str] = list(specials)
        for tok, freq in counter.most_common(max_size):
            if freq < min_freq:
                break
            if tok not in self.itos:
                self.itos.append(tok)
        self.stoi: Dict[str, int] = {t: i for i, t in enumerate(self.itos)}
        self.pad_id = 0
        self.unk_id = 1
        self.bos_id = 2
        self.eos_id = 3

    def __len__(self):
        return len(self.itos)

    def encode(self, tokens: List[str]) -> List[int]:
        return [self.stoi.get(t, self.unk_id) for t in tokens]

    def decode(self, ids: List[int]) -> List[str]:
        return [self.itos[i] if 0 <= i < len(self.itos) else "<unk>"
                for i in ids]

    @classmethod
    def build_from_texts(cls, texts, tokenizer=None, **kw):
        tokenizer = tokenizer or (lambda s: s.lower().split())
        counter = Counter()
        for t in texts:
            counter.update(tokenizer(t))
        return cls(counter, **kw)


_SYNTH_POS = ["great wonderful amazing film loved it",
              "brilliant acting and a moving story",
              "best movie of the year truly superb"]
_SYNTH_NEG = ["terrible boring waste of time",
              "awful script and wooden acting",
              "worst film i have ever seen"]


class Imdb(Dataset):
    """Sentiment dataset (reference: paddle.text.Imdb). Reads an
    aclImdb-layout directory when given, else a deterministic synthetic
    corpus with the same interface."""

    def __init__(self, data_dir: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, seq_len: int = 32,
                 synthetic_size: int = 200):
        texts, labels = [], []
        if data_dir and os.path.isdir(data_dir):
            for label, sub in ((1, "pos"), (0, "neg")):
                droot = os.path.join(data_dir, mode, sub)
                for fn in sorted(os.listdir(droot)):
                    with open(os.path.join(droot, fn),
                              encoding="utf-8") as f:
                        texts.append(f.read())
                    labels.append(label)
        else:
            rng = np.random.default_rng(0 if mode == "train" else 1)
            for i in range(synthetic_size):
                if i % 2 == 0:
                    base = _SYNTH_POS[int(rng.integers(len(_SYNTH_POS)))]
                    labels.append(1)
                else:
                    base = _SYNTH_NEG[int(rng.integers(len(_SYNTH_NEG)))]
                    labels.append(0)
                texts.append(base)
        self.vocab = Vocab.build_from_texts(texts)
        self.seq_len = seq_len
        self.samples = []
        for t, l in zip(texts, labels):
            ids = self.vocab.encode(t.lower().split())[:seq_len]
            ids = ids + [self.vocab.pad_id] * (seq_len - len(ids))
            self.samples.append((np.asarray(ids, np.int64), np.int64(l)))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class SyntheticLMDataset(Dataset):
    """Token-stream LM dataset for GPT training/benchmarks (markov-ish
    synthetic stream so models can actually reduce loss)."""

    def __init__(self, vocab_size: int = 1024, seq_len: int = 128,
                 size: int = 512, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.size = size
        # deterministic transition table gives learnable structure
        self._next = rng.integers(0, vocab_size, vocab_size)
        self._seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self._seed + idx)
        seq = np.empty(self.seq_len + 1, np.int64)
        seq[0] = rng.integers(self.vocab_size)
        for i in range(1, self.seq_len + 1):
            if rng.random() < 0.8:
                seq[i] = self._next[seq[i - 1]]
            else:
                seq[i] = rng.integers(self.vocab_size)
        return seq[:-1], seq[1:]

    def __len__(self):
        return self.size


def viterbi_decode(potentials, transitions):
    """Sequence-tagging decode (reference: ``paddle.text.viterbi_decode``).
    potentials ``[B, T, N]``, transitions ``[N, N]`` (tensors, eager
    ``Tensor``s or arrays; arrays go to the expected place). Returns
    ``(scores [B] float32, paths [B, T] int32)``, the JAX dtypes under
    the x32 policy, on the potentials' device. Ties take the first
    maximum, as ``jnp.argmax`` does."""
    import torch

    from ..tensor import unwrap

    def as_tensor(x):
        x = unwrap(x)
        if isinstance(x, torch.Tensor):
            return x
        from ..device import resolve_device
        return torch.as_tensor(np.asarray(x), device=resolve_device(None))

    pot = as_tensor(potentials)
    if pot.dtype == torch.float64:  # x32, as the JAX package reads it
        pot = pot.to(torch.float32)
    trans = as_tensor(transitions).to(pot.device, pot.dtype)
    score = pot[:, 0]
    backs = []
    for t in range(1, pot.shape[1]):
        cand = score[:, :, None] + trans[None] + pot[:, t, None, :]
        score, back = torch.max(cand, dim=1)
        backs.append(back)
    final_scores, last = torch.max(score, dim=-1)
    path = [last]
    for back in reversed(backs):
        path.append(torch.gather(back, 1, path[-1][:, None])[:, 0])
    paths = torch.stack(path[::-1], dim=1).to(torch.int32)
    return final_scores.to(torch.float32), paths


class UCIHousing(Dataset):
    """Boston housing regression (reference: paddle.text.UCIHousing,
    text/datasets/uci_housing.py: 13 features -> price). Reads the
    whitespace-separated housing.data file when given; else a
    deterministic synthetic linear-model corpus."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 download: bool = True, synthetic_size: int = 404):
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file, dtype=np.float32)
            feats, prices = raw[:, :-1], raw[:, -1:]
            # reference normalizes features by train-split statistics
            mx, mn = feats.max(0), feats.min(0)
            feats = (feats - feats.mean(0)) / np.maximum(mx - mn, 1e-6)
            split = int(len(raw) * 0.8)
            if mode == "train":
                feats, prices = feats[:split], prices[:split]
            else:
                feats, prices = feats[split:], prices[split:]
        else:
            rng = np.random.default_rng(0 if mode == "train" else 1)
            feats = rng.standard_normal(
                (synthetic_size, self.FEATURE_DIM)).astype(np.float32)
            w = np.linspace(-1.0, 1.0, self.FEATURE_DIM, dtype=np.float32)
            prices = (feats @ w[:, None] + 22.5 +
                      0.1 * rng.standard_normal((synthetic_size, 1))
                      ).astype(np.float32)
        self.samples = [(feats[i], prices[i]) for i in range(len(feats))]

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Imikolov(Dataset):
    """PTB n-gram/sequence dataset (reference: paddle.text.Imikolov,
    text/datasets/imikolov.py). data_type='NGRAM' yields window_size word
    ids; 'SEQ' yields (src, trg) shifted sequences. Local PTB text file
    or deterministic synthetic corpus."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 1, seq_len: int = 20,
                 synthetic_size: int = 500):
        if data_file and os.path.exists(data_file):
            with open(data_file, encoding="utf-8") as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        else:
            rng = np.random.default_rng(0 if mode == "train" else 1)
            words = ["the", "of", "market", "stock", "bank", "price",
                     "trade", "rate", "dollar", "share"]
            lines = [" ".join(words[int(j)] for j in
                              rng.integers(0, len(words), 12))
                     for _ in range(synthetic_size)]
        self.vocab = Vocab.build_from_texts(lines, min_freq=min_word_freq)
        self.samples = []
        for ln in lines:
            ids = self.vocab.encode(ln.lower().split())
            if data_type.upper() == "NGRAM":
                for i in range(len(ids) - window_size + 1):
                    self.samples.append(tuple(
                        np.int64(t) for t in ids[i:i + window_size]))
            else:
                seq = [self.vocab.bos_id] + ids[:seq_len] + \
                    [self.vocab.eos_id]
                src = np.asarray(seq[:-1], np.int64)
                trg = np.asarray(seq[1:], np.int64)
                self.samples.append((src, trg))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """MovieLens-1M rating dataset (reference: paddle.text.Movielens,
    text/datasets/movielens.py): samples are (user_id, gender, age, job,
    movie_id, category_ids, title_ids, rating). Reads the ml-1m directory
    when given; else deterministic synthetic interactions."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0,
                 synthetic_size: int = 600):
        rng = np.random.default_rng(rand_seed)
        if data_file and os.path.isdir(data_file):
            ratings = os.path.join(data_file, "ratings.dat")
            rows = []
            with open(ratings, encoding="latin-1") as f:
                for ln in f:
                    u, m, r, _ = ln.strip().split("::")
                    rows.append((int(u), int(m), float(r)))
        else:
            rows = [(int(rng.integers(1, 500)), int(rng.integers(1, 300)),
                     float(rng.integers(1, 6)))
                    for _ in range(synthetic_size)]
        self.samples = []
        for u, m, r in rows:
            is_test = rng.random() < test_ratio
            if (mode == "test") != is_test:
                continue
            gender = np.int64(u % 2)
            age = np.int64(u % 7)
            job = np.int64(u % 21)
            cats = np.asarray([m % 18, (m * 7) % 18], np.int64)
            title = np.asarray([(m * 13 + k) % 5000 for k in range(4)],
                               np.int64)
            self.samples.append((np.int64(u), gender, age, job,
                                 np.int64(m), cats, title,
                                 np.float32(r)))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


def _expand_srl_column(col):
    """One predicate column of a CoNLL-05 props file -> B/I/O tags.
    Tokens are '*' (continue), '*)' (close), '(TAG*' (open), '(TAG*)'
    (single-token span). Reference semantics: conll05.py:200-222."""
    out, cur, inside = [], None, False
    for tok in col:
        if tok == "*":
            out.append("I-" + cur if inside else "O")
        elif tok == "*)":
            out.append("I-" + cur)
            inside = False
        elif "(" in tok and "*" in tok:
            cur = tok[1:tok.index("*")]
            out.append("B-" + cur)
            inside = ")" not in tok
        else:
            raise ValueError(f"unexpected props token: {tok!r}")
    return out


def _parse_conll05_tar(data_file):
    """The official conll05st-release tar: words/*.words.gz (one token
    per line, blank line ends a sentence) zipped against
    props/*.props.gz (column 0 = verb lemma or '-', one tag column per
    predicate). Yields (words, predicate_lemma, bio_labels) per
    (sentence, predicate) pair — reference: conll05.py:172-235."""
    import gzip
    import tarfile

    with tarfile.open(data_file) as tf:
        def key_of(name, suffix):
            # shared section key: basename minus the member suffix (e.g.
            # "test.wsj" from "words/test.wsj/test.wsj.words.gz") — name
            # order alone could zip mismatched sections if the tar
            # carries extra or renamed members
            return name.rsplit("/", 1)[-1][:-len(suffix)]

        words_by = {key_of(n, ".words.gz"): n for n in tf.getnames()
                    if n.endswith(".words.gz")}
        props_by = {key_of(n, ".props.gz"): n for n in tf.getnames()
                    if n.endswith(".props.gz")}
        if not words_by or set(words_by) != set(props_by):
            raise ValueError(
                f"{data_file} needs matching words.gz/props.gz members "
                f"(words sections {sorted(words_by)}, props sections "
                f"{sorted(props_by)})")
        word_lines, prop_lines = [], []
        # every section (e.g. test.wsj AND test.brown), paired by key
        for sec in sorted(words_by):
            wn, pn = words_by[sec], props_by[sec]
            with gzip.GzipFile(fileobj=tf.extractfile(wn)) as wf:
                word_lines += [l.decode().strip() for l in wf]
                word_lines.append("")  # section boundary = sentence end
            with gzip.GzipFile(fileobj=tf.extractfile(pn)) as pf:
                prop_lines += [l.decode().strip().split() for l in pf]
                prop_lines.append([])

    samples = []
    words, rows = [], []

    def flush():
        if words:
            lemmas = [r[0] for r in rows if r[0] != "-"]
            n_pred = len(rows[0]) - 1 if rows else 0
            for i in range(n_pred):
                col = [r[i + 1] for r in rows]
                samples.append((words[:], lemmas[i],
                                _expand_srl_column(col)))

    for word, row in zip(word_lines, prop_lines):
        if not word and not row:  # sentence boundary
            flush()
            words, rows = [], []
        else:
            words.append(word)
            rows.append(row)
    flush()  # archives without a trailing blank line
    return samples


class Conll05st(Dataset):
    """CoNLL-2005 semantic role labeling (reference: paddle.text.Conll05st,
    text/datasets/conll05.py): samples are (word_ids[T], predicate_id,
    mark[T], label_ids[T]) at fixed seq_len (TPU static shapes; the
    reference returns ragged context arrays). Given the official release
    tar via ``data_file`` (+ optional word/verb/target dict files, one
    entry per line) it parses the real words/props format; otherwise it
    serves deterministic synthetic sentences. ``mark`` flags the
    reference's 5-token predicate context window (conll05.py:246-276).
    In real-archive mode ``mode`` is ignored — like the reference, whose
    Conll05st serves only the public test sections (conll05.py:65-67) —
    and out-of-vocabulary words map to id 0, the reference's UNK_IDX
    convention (conll05.py:52: the released dicts put UNK at row 0)."""

    NUM_LABELS = 9

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 seq_len: int = 16, synthetic_size: int = 200,
                 word_dict_file: Optional[str] = None,
                 verb_dict_file: Optional[str] = None,
                 target_dict_file: Optional[str] = None):
        rng = np.random.default_rng(0 if mode == "train" else 1)
        self.seq_len = seq_len
        self.word_dict = self.predicate_dict = self.label_dict = None
        if data_file and os.path.exists(data_file):
            raw = _parse_conll05_tar(data_file)
            self.word_dict = self._load_or_build_dict(
                word_dict_file, sorted({w for ws, _, _ in raw
                                        for w in ws}))
            self.predicate_dict = self._load_or_build_dict(
                verb_dict_file, sorted({p for _, p, _ in raw}))
            self.label_dict = self._build_label_dict(
                target_dict_file, raw)
            self.samples = [self._encode(*s) for s in raw]
            return
        self.samples = []
        for _ in range(synthetic_size):
            t = int(rng.integers(5, seq_len + 1))
            words = rng.integers(4, 200, t)
            pred = int(rng.integers(0, t))
            mark = np.zeros(seq_len, np.int64)
            mark[pred] = 1
            wid = np.zeros(seq_len, np.int64)
            wid[:t] = words
            labels = np.zeros(seq_len, np.int64)
            labels[:t] = rng.integers(0, self.NUM_LABELS, t)
            self.samples.append((wid, np.int64(pred), mark, labels))

    @staticmethod
    def _load_or_build_dict(path, fallback_entries):
        if path and os.path.exists(path):
            with open(path) as f:
                return {ln.strip(): i for i, ln in enumerate(f)
                        if ln.strip()}
        return {w: i for i, w in enumerate(fallback_entries)}

    @staticmethod
    def _build_label_dict(path, raw):
        """B-X/I-X pairs for every tag, then 'O' last (reference:
        conll05.py:146-163 load_label_dict)."""
        if path and os.path.exists(path):
            with open(path) as f:
                tags = sorted({ln.strip()[2:] for ln in f
                               if ln.strip()[:2] in ("B-", "I-")})
        else:
            tags = sorted({lb[2:] for _, _, lbs in raw
                           for lb in lbs if lb != "O"})
        d = {}
        for t in tags:
            d["B-" + t] = len(d)
            d["I-" + t] = len(d)
        d["O"] = len(d)
        return d

    def _encode(self, words, predicate, labels):
        T = self.seq_len
        unk = 0
        wid = np.zeros(T, np.int64)
        lid = np.full(T, self.label_dict["O"], np.int64)
        mark = np.zeros(T, np.int64)
        n = min(len(words), T)
        wid[:n] = [self.word_dict.get(w, unk) for w in words[:n]]
        lid[:n] = [self.label_dict[lb] for lb in labels[:n]]
        v = labels.index("B-V")
        for k in range(max(0, v - 2), min(len(labels), v + 3)):
            if k < T:
                mark[k] = 1
        pred = np.int64(self.predicate_dict.get(predicate, 0))
        return wid, pred, mark, lid

    def get_dict(self):
        """(word_dict, predicate_dict, label_dict) — real-archive mode
        only (reference: conll05.py get_dict)."""
        return self.word_dict, self.predicate_dict, self.label_dict

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class WMT14(Dataset):
    """WMT'14 en-fr translation (reference: paddle.text.WMT14,
    text/datasets/wmt14.py): samples are (src_ids, trg_ids,
    trg_ids_next). Local parallel corpus (tab-separated src\\ttrg lines)
    or deterministic synthetic pairs."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 dict_size: int = 1000, seq_len: int = 16,
                 synthetic_size: int = 300):
        self.dict_size = dict_size
        rng = np.random.default_rng(
            (14 if mode == "train" else 15))
        pairs = []
        if data_file and os.path.exists(data_file):
            with open(data_file, encoding="utf-8") as f:
                for ln in f:
                    if "\t" in ln:
                        s, t = ln.rstrip("\n").split("\t")[:2]
                        pairs.append((s.split(), t.split()))
            texts = [" ".join(s) + " " + " ".join(t) for s, t in pairs]
            self.vocab = Vocab.build_from_texts(texts,
                                                max_size=dict_size)
            # the default vocab tokenizer lowercases; match it here
            enc = lambda toks: self.vocab.encode(
                [t.lower() for t in toks])  # noqa: E731
        else:
            self.vocab = None
            for _ in range(synthetic_size):
                t = int(rng.integers(4, seq_len))
                src = rng.integers(4, dict_size, t)
                trg = (src[::-1] % dict_size)  # learnable mapping
                pairs.append((src, trg))
            enc = None
        self.samples = []
        bos, eos = 2, 3
        for s, t in pairs:
            sid = np.asarray(enc(s) if enc else s, np.int64)[:seq_len]
            tid = np.asarray(enc(t) if enc else t, np.int64)[:seq_len - 1]
            trg_in = np.concatenate([[bos], tid]).astype(np.int64)
            trg_next = np.concatenate([tid, [eos]]).astype(np.int64)
            self.samples.append((sid, trg_in, trg_next))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class WMT16(WMT14):
    """WMT'16 en-de translation (reference: paddle.text.WMT16,
    text/datasets/wmt16.py) — same sample contract as WMT14."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = 1000, trg_dict_size: int = 1000,
                 src_lang: str = "en", seq_len: int = 16,
                 synthetic_size: int = 300):
        super().__init__(data_file, mode,
                         max(src_dict_size, trg_dict_size), seq_len,
                         synthetic_size)
