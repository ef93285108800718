"""Text data files: CSV / TSV / LibSVM with sidecar files (port of
``lightgbm_tpu/data/file_loader.py``).

Reference analog: ``Parser::CreateParser`` format detection
(src/io/parser.cpp:1-222), ``DatasetLoader`` header / label / weight /
group / ignore column resolution and the ``.weight`` / ``.query`` /
``.group`` / ``.init`` sidecars (src/io/dataset_loader.cpp:31-167,
metadata.cpp).

The JAX package parses with its native C++ parser (``std::from_chars``,
junk -> NaN: the reference's tolerant ``Common::Atof``) and falls back
to pandas. This port uses numpy and the standard library only, with the
native parser's token rules, so the arrays equal JAX's bit for bit:

  * a token is trimmed of leading spaces and tabs and trailing spaces,
    tabs and carriage returns; an empty token is NaN;
  * a number is ``-?(digits[.digits] | .digits)`` with an optional
    exponent, or ``inf`` / ``infinity`` / ``nan[(chars)]`` in any case,
    and one leading ``+`` may precede either; it is the correctly
    rounded float64, except that a value out of float64's range (an
    overflow, or an underflow to zero) is NaN, as ``from_chars``
    reports it;
  * anything else is NaN;
  * a LibSVM feature is a whitespace-separated token (not the line's
    first, which is the label) whose part before its first colon is a
    run of ASCII digits; other tokens (``qid:3``, comments) are skipped.

Bulk files take a vectorized path (one numpy conversion of all tokens)
whenever their bytes can only form tokens on which numpy's conversion
and those rules agree; anything else is parsed token by token. A file
with quoted or ragged rows raises.
"""

from __future__ import annotations

import math
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.log import log_fatal, log_info

_NUMBER = re.compile(r"-?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][-+]?[0-9]+)?")
_SPECIAL = re.compile(r"-?(?:inf(?:inity)?|nan(?:\([0-9A-Za-z_]*\))?)",
                      re.IGNORECASE | re.ASCII)
# bytes from which numpy's float conversion and the token rules above
# can only form tokens they parse alike (or tokens both reject)
_SIMPLE = b"0123456789.eE+-nNaAiIfFtTyY \t"
# whitespace that str.split() cuts at besides space, tab and newline
_OTHER_SPACE = b"\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0"


def detect_format(path: str) -> str:
    """CSV / TSV / LibSVM sniffing (Parser::CreateParser: colon tokens
    against tab / comma splits on the first lines)."""
    with open(path) as f:
        lines = []
        for line in f:
            line = line.strip()
            if line:
                lines.append(line)
            if len(lines) >= 2:
                break
    if not lines:
        log_fatal(f"Data file {path} is empty")
    probe = lines[-1]
    tokens = probe.replace("\t", " ").split()
    n_colon = sum(1 for t in tokens if ":" in t)
    if n_colon > 0 and n_colon >= len(tokens) - 1:
        return "libsvm"
    if "\t" in probe:
        return "tsv"
    return "csv"


def _resolve_column(spec: str, names: Optional[List[str]]) -> Optional[int]:
    """'name:<col>' or integer index (dataset_loader.cpp:31-90)."""
    if not spec:
        return None
    if spec.startswith("name:"):
        col = spec[5:]
        if names is None or col not in names:
            log_fatal(f"Could not find column {col} in data file header")
        return names.index(col)
    return int(spec)


def _resolve_ignore(spec: str, names: Optional[List[str]]) -> List[int]:
    if not spec:
        return []
    if spec.startswith("name:"):
        return [names.index(col) for col in spec[5:].split(",")
                if names is not None and col in names]
    return [int(c) for c in spec.split(",")]


def _qid_to_group_sizes(qid: np.ndarray) -> np.ndarray:
    """Per-row query ids -> query sizes (Metadata::SetQueryId)."""
    change = np.nonzero(np.diff(qid))[0]
    bounds = np.concatenate([[0], change + 1, [len(qid)]])
    return np.diff(bounds)


# ----------------------------------------------------------------------
def atof(token: str) -> float:
    """One token by the rules of the module docstring."""
    t = token.lstrip(" \t").rstrip(" \t\r")
    for s in (t, t[1:] if t[:1] == "+" else None):
        if not s:
            break
        if _NUMBER.fullmatch(s):
            v = float(s)
            mantissa = s.partition("e")[0].partition("E")[0]
            if math.isinf(v) or (v == 0.0
                                 and mantissa.strip("-.0") != ""):
                return math.nan
            return v
        if _SPECIAL.fullmatch(s):
            v = math.nan if "a" in s.lower() else math.inf
            return -v if s[0] == "-" else v
    return math.nan


def _parse_tokens(tokens: List[str], simple: bool) -> np.ndarray:
    """float64 of every token. ``simple`` says that the tokens' bytes
    are all in ``_SIMPLE``: then one numpy conversion parses them, and
    only its zeros and non-finite values, where an underflow, an
    overflow or a literal may hide, are parsed again one by one."""
    if simple:
        try:
            v = np.array(tokens, dtype=np.float64)
        except ValueError:  # a junk token: NaN, one by one below
            v = None
        if v is not None:
            seen = {}
            for i in np.flatnonzero((v == 0) | ~np.isfinite(v)):
                t = tokens[i]
                if t not in seen:
                    seen[t] = atof(t)
                v[i] = seen[t]
            return v
    return np.fromiter((atof(t) for t in tokens), np.float64, len(tokens))


def _iter_data_lines(path: str, skip: int):
    """The file's non-blank lines (blank: only spaces, tabs and carriage
    returns) without their trailing carriage returns, after skipping
    ``skip`` of them (the header)."""
    with open(path, "rb") as f:
        for ln in f:
            ln = ln.rstrip(b"\n").rstrip(b"\r")
            if not ln.strip(b" \t\r"):
                continue
            if skip:
                skip -= 1
                continue
            yield ln


def _data_lines(path: str, skip: int) -> List[bytes]:
    return list(_iter_data_lines(path, skip))


def _parse_dense(path: str, sep: str, skip: int) -> np.ndarray:
    lines = _data_lines(path, skip)
    if not lines:
        log_fatal(f"Data file {path} has no data rows")
    return _dense_from_lines(lines, sep, path)


def _dense_from_lines(lines: List[bytes], sep: str, path: str) -> np.ndarray:
    """The float64 matrix of a run of CSV / TSV data lines."""
    d = sep.encode()
    cols = lines[0].count(d) + 1
    if any(ln.count(d) != cols - 1 for ln in lines):
        log_fatal(f"Data file {path} has rows with other than {cols} "
                  "columns")
    body = b"\n".join(lines)
    if b'"' in body and re.search(rb'(?:^|' + re.escape(d) + rb')[ \t]*"',
                                  body, re.M):
        log_fatal(f"Data file {path} has quoted fields, which the port's "
                  "parser does not read")
    tokens = body.decode("latin-1").replace("\n", sep).split(sep)
    simple = not body.translate(None, _SIMPLE + d + b"\n")
    return _parse_tokens(tokens, simple).reshape(len(lines), cols)


def _parse_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """LibSVM text -> (dense matrix, labels) (LibSVMParser,
    src/io/parser.hpp:84-122). Indices are kept as given (0- or
    1-based); the matrix is as wide as the largest index + 1."""
    lines = _data_lines(path, 0)
    if not lines:
        log_fatal(f"Data file {path} is empty")
    return _libsvm_from_lines(lines)


def _libsvm_from_lines(lines: List[bytes], width: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(dense matrix, labels) of a run of LibSVM lines; the matrix is
    ``width`` columns wide, or as wide as its largest index + 1."""
    body = b"\n".join(lines)
    text = body.decode("latin-1")
    labels, idx, vals, counts = None, None, None, None
    if len(body.translate(None, _OTHER_SPACE)) == len(body):
        rows = text.split("\n")
        if "\t" in text or "  " in text or " \n" in text or "\n " in text \
                or text[0] == " " or text[-1] == " ":
            rows = [" ".join(ln.split()) for ln in rows]
        heads = [ln.partition(" ") for ln in rows]     # label, features
        feats = " ".join(h[2] for h in heads if h[2])
        counts = [ln.count(" ") for ln in rows]
        total = sum(counts)
        # every token a feature: one colon a token (colons and the
        # spaces between tokens alternate), digits before it
        b = np.frombuffer(feats.encode("latin-1"), np.uint8)
        colon, space = np.flatnonzero(b == 58), np.flatnonzero(b == 32)
        parts = feats.replace(":", " ").split(" ") if total else []
        digits = "".join(parts[0::2])
        if len(colon) == total and (space > colon[:-1]).all() \
                and (space < colon[1:]).all() and "" not in parts[0::2] \
                and (not total or (digits.isascii() and digits.isdigit())):
            simple = not body.translate(None, _SIMPLE + b":\n")
            labels = _parse_tokens([h[0] for h in heads], simple)
            idx = np.array(parts[0::2], dtype=np.int64)
            vals = _parse_tokens(parts[1::2], simple)
    if labels is None:   # token by token, with the native skip rules
        lab, idx_l, val_l, counts = [], [], [], []
        for ln in text.split("\n"):
            toks = [t for t in ln.replace("\t", " ").split(" ") if t]
            lab.append(atof(toks[0]))
            c0 = len(idx_l)
            for t in toks[1:]:
                i, colon, v = t.partition(":")
                if colon and i.isascii() and i.isdigit():
                    idx_l.append(int(i))
                    val_l.append(atof(v))
            counts.append(len(idx_l) - c0)
        labels = np.asarray(lab, np.float64)
        idx = np.asarray(idx_l, np.int64)
        vals = np.asarray(val_l, np.float64)
    if width is None:
        width = int(idx.max(initial=-1)) + 1
    X = np.zeros((len(labels), width))
    X[np.repeat(np.arange(len(labels)), counts), idx] = vals
    return X, labels


def _load_sidecar(path: str, suffixes) -> Optional[np.ndarray]:
    """Metadata sidecar files (src/io/metadata.cpp LoadWeights /
    LoadQueryBoundaries: one value per line, an optional header)."""
    for suffix in suffixes:
        p = path + suffix
        if os.path.exists(p):
            vals = []
            with open(p) as f:
                for i, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        vals.append(float(line))
                    except ValueError:
                        if i == 0:
                            continue  # header line
                        raise
            return np.asarray(vals)
    return None


def _resolve_columns(config: Config, names: Optional[List[str]],
                     total_cols: int):
    """(label, weight, group column or None, kept feature columns) of a
    dense file (dataset_loader.cpp:31-167)."""
    label_idx = _resolve_column(config.label_column, names)
    if label_idx is None:
        label_idx = 0
    weight_idx = _resolve_column(config.weight_column, names)
    group_idx = _resolve_column(config.group_column, names)
    drop = {label_idx} | set(_resolve_ignore(config.ignore_column, names))
    drop |= {i for i in (weight_idx, group_idx) if i is not None}
    keep = [i for i in range(total_cols) if i not in drop]
    return label_idx, weight_idx, group_idx, keep


def _header_names(path: str, sep: str) -> List[str]:
    with open(path) as f:
        head_line = f.readline().rstrip("\n")
    return [c.strip() for c in head_line.split(sep)]


def load_file(path: str, config: Config) -> Tuple[
        np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
        Optional[np.ndarray], Optional[np.ndarray], Optional[List[str]]]:
    """Load a data file -> (X, label, weight, group, init_score,
    feature_names).

    Mirrors DatasetLoader::LoadFromFile column resolution: the label is
    the first column unless ``label_column`` says otherwise; label,
    weight, group and ignored columns leave the feature matrix;
    ``.weight`` and ``.query`` / ``.group`` sidecars override in-file
    columns, and ``.init`` gives the initial scores.
    """
    if not os.path.exists(path):
        log_fatal(f"Data file {path} does not exist")
    fmt = detect_format(path)
    label = weight = group = None
    names: Optional[List[str]] = None

    if fmt == "libsvm":
        X, label = _parse_libsvm(path)
    else:
        sep = "\t" if fmt == "tsv" else ","
        if config.header:
            names = _header_names(path, sep)
        mat = _parse_dense(path, sep, 1 if config.header else 0)
        label_idx, weight_idx, group_idx, keep = _resolve_columns(
            config, names, mat.shape[1])
        if weight_idx is not None:
            weight = mat[:, weight_idx]
        if group_idx is not None:
            group = _qid_to_group_sizes(mat[:, group_idx])
        label = mat[:, label_idx]
        X = mat[:, keep]
        if names is not None:
            names = [names[i] for i in keep]

    sc_weight = _load_sidecar(path, (".weight",))
    if sc_weight is not None:
        weight = sc_weight
    sc_group = _load_sidecar(path, (".query", ".group"))
    if sc_group is not None:
        group = sc_group.astype(np.int64)
    if group is not None:
        group = np.asarray(group, np.int64)
    init_score = _load_sidecar(path, (".init",))
    log_info(f"Loaded {X.shape[0]} rows x {X.shape[1]} features "
             f"from {path} ({fmt})")
    return X, label, weight, group, init_score, names


# data lines a two-round chunk holds (~34 MB of float64 at 64 columns)
TWO_ROUND_CHUNK_ROWS = 65_536


class TwoRoundLoader:
    """Chunked text ingestion for ``two_round=true`` (JAX
    ``data/file_loader.py:229 TwoRoundLoader``; the reference's two_round
    branch of DatasetLoader::LoadFromFile, dataset_loader.cpp:201-216):
    each pass streams the file ``chunk_rows`` data lines at a time, so
    the float64 matrix of the whole file never exists. Every chunk is
    parsed by the token rules of ``load_file`` and its columns resolved
    the same way, so the rows equal the in-memory path's bit for bit;
    LibSVM chunks are as wide as the file's largest index + 1 (one scan
    of the indices first)."""

    def __init__(self, path: str, config: Config,
                 chunk_rows: Optional[int] = None):
        if not os.path.exists(path):
            log_fatal(f"Data file {path} does not exist")
        self.path = path
        self.config = config
        self.chunk_rows = int(chunk_rows or TWO_ROUND_CHUNK_ROWS)
        self.fmt = detect_format(path)
        self.sep = "\t" if self.fmt == "tsv" else ","
        self.names = _header_names(path, self.sep) \
            if self.fmt != "libsvm" and config.header else None
        self._cols = None     # (label, weight, group, keep) of a dense file
        self._width = None    # a LibSVM file's matrix width
        self.feature_names: Optional[List[str]] = None

    def _line_chunks(self):
        """The file's data lines (``_iter_data_lines``), in runs of at
        most ``chunk_rows``."""
        skip = 1 if self.fmt != "libsvm" and self.config.header else 0
        run: List[bytes] = []
        for ln in _iter_data_lines(self.path, skip):
            run.append(ln)
            if len(run) >= self.chunk_rows:
                yield run
                run = []
        if run:
            yield run

    def count_rows(self) -> int:
        return sum(len(run) for run in self._line_chunks())

    def _resolve(self, total_cols: int) -> None:
        self._total = total_cols
        self._cols = _resolve_columns(self.config, self.names, total_cols)
        if self.names is not None:
            self.feature_names = [self.names[i] for i in self._cols[3]]

    def resolve_feature_names(self) -> Optional[List[str]]:
        """The feature columns' header names (None without a header),
        from the first data line's column count."""
        if self._cols is None and self.fmt != "libsvm":
            for run in self._line_chunks():
                self._resolve(run[0].count(self.sep.encode()) + 1)
                break
        return self.feature_names

    def iter_chunks(self):
        """``(X, label, weight, qid)`` a chunk in file order: ``X`` float64
        [m, features], the rest [m] or None."""
        if self.fmt == "libsvm":
            if self._width is None:
                self._width = 0
                for run in self._line_chunks():
                    self._width = max(self._width,
                                      _libsvm_from_lines(run)[0].shape[1])
            for run in self._line_chunks():
                X, label = _libsvm_from_lines(run, self._width)
                yield X, label, None, None
            return
        for run in self._line_chunks():
            mat = _dense_from_lines(run, self.sep, self.path)
            if self._cols is None:
                self._resolve(mat.shape[1])
            label_idx, weight_idx, group_idx, keep = self._cols
            if mat.shape[1] != self._total:
                log_fatal(f"Data file {self.path} has rows with other "
                          f"than {self._total} columns")
            yield (mat[:, keep], mat[:, label_idx],
                   None if weight_idx is None else mat[:, weight_idx],
                   None if group_idx is None else mat[:, group_idx])

    def load_sidecars(self):
        """(weight, group, init_score) from the files beside the data."""
        weight = _load_sidecar(self.path, (".weight",))
        group = _load_sidecar(self.path, (".query", ".group"))
        if group is not None:
            group = group.astype(np.int64)
        return weight, group, _load_sidecar(self.path, (".init",))
