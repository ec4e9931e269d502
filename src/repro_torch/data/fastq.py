"""FASTQ read I/O + quality trimming (mirrors `repro.data.fastq`).

Parse FASTQ text, quality-trim 3' ends, drop short reads, and pack into
the dense ReadSet layout (CPU tensors).  Paired files interleave as
(r1, r2, r1, r2, ...), mgsim's mate convention.

Parsing streams: records come off a line iterator one at a time
(`iter_fastq_records`), and `iter_fastq_batches` chunks them into
capacity-padded fixed-shape batches for the out-of-core pipeline, so a
large file never materializes as a line list.  Malformed records raise
`FastqParseError` with the line number; a trailing partial record
(truncated download, live file) is dropped.
"""
from __future__ import annotations

import io
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.types import INVALID_BASE, ReadSet

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


class FastqParseError(ValueError):
    """A malformed FASTQ record (with the 1-based line number)."""


def _open_lines(source) -> Iterator[str]:
    """str -> line iterator over the text or the file at that path; a
    handle or any line iterable passes through.

    A str holding a newline is FASTQ text (paths cannot hold one), as is a
    blank str or a single truncated record line starting with '@'; other
    strs open as files, lazily, so the handle closes when iteration ends.
    """
    if isinstance(source, str):
        if ("\n" in source or not source.strip()
                or source.lstrip().startswith("@")):
            return iter(io.StringIO(source))

        def from_path():
            with open(source) as f:
                yield from f

        return from_path()
    return iter(source)


def iter_fastq_records(source) -> Iterator[tuple]:
    """Stream (seq_codes uint8[:], quals uint8[:]) records.

    `source` is FASTQ text, a path, a file handle or any line iterable.
    Blank lines are skipped.  Malformed records raise `FastqParseError`; a
    partial record at EOF (fewer than 4 lines) is dropped.
    """
    buf = []  # [(lineno, line)]: real file line numbers survive blanks
    for lineno, raw in enumerate(_open_lines(source), start=1):
        line = raw.strip()
        if not line:
            continue
        buf.append((lineno, line))
        if len(buf) < 4:
            continue
        (h_ln, header), (s_ln, seq), (p_ln, plus), (_, qual) = buf
        buf = []
        if not header.startswith("@"):
            raise FastqParseError(
                f"line {h_ln}: expected header starting with '@', "
                f"got {header[:40]!r}"
            )
        if not plus.startswith("+"):
            raise FastqParseError(
                f"line {p_ln}: expected '+' separator, got {plus[:40]!r}"
            )
        if len(seq) != len(qual):
            raise FastqParseError(
                f"line {s_ln}: sequence length {len(seq)} != quality "
                f"length {len(qual)} for record {header[:40]!r}"
            )
        codes = _CODE[np.frombuffer(seq.encode(), np.uint8)]
        quals = (np.frombuffer(qual.encode(), np.uint8) - 33).astype(np.uint8)
        yield codes, quals


def parse_fastq(text: str):
    """-> list of (seq_codes uint8[:], quals uint8[:])."""
    return list(iter_fastq_records(text))


def quality_trim(seq, qual, min_q: int = 10):
    """Trim the 3' tail from the first position whose quality is below
    min_q."""
    bad = qual < min_q
    if bad.any():
        cut = int(np.argmax(bad))
        return seq[:cut], qual[:cut]
    return seq, qual


def _pack(trimmed, *, R: int, L: int, min_len: int, paired: bool,
          insert_size: int) -> ReadSet:
    """Dense [R, L] ReadSet from trimmed records; rows past the records
    are inert (zero length, INVALID bases, mate -1), as are reads shorter
    than min_len."""
    n = len(trimmed)
    bases = np.full((R, L), INVALID_BASE, np.uint8)
    lengths = np.zeros((R,), np.int32)
    for i, (s, _) in enumerate(trimmed):
        s = s[:L]
        if len(s) >= min_len:
            bases[i, : len(s)] = s
            lengths[i] = len(s)
    if paired:
        mate = np.where(np.arange(R) < n, np.arange(R, dtype=np.int32) ^ 1,
                        -1).astype(np.int32)
    else:
        mate = np.full((R,), -1, np.int32)
    return ReadSet(bases=torch.from_numpy(bases),
                   lengths=torch.from_numpy(lengths),
                   mate=torch.from_numpy(mate), insert_size=insert_size)


def to_readset(records: Iterable, *, max_len: int | None = None,
               min_len: int = 32, insert_size: int = 200, trim_q: int = 10,
               paired: bool = True) -> ReadSet:
    trimmed = [quality_trim(s, q, trim_q) for s, q in records]
    if paired and len(trimmed) % 2:
        trimmed = trimmed[:-1]
    L = max_len or max((len(s) for s, _ in trimmed), default=32)
    return _pack(trimmed, R=len(trimmed), L=L, min_len=min_len,
                 paired=paired, insert_size=insert_size)


def iter_fastq_batches(source, *, batch_reads: int, max_len: int,
                       min_len: int = 32, insert_size: int = 200,
                       trim_q: int = 10,
                       paired: bool = True) -> Iterator[ReadSet]:
    """Stream fixed-shape `[batch_reads, max_len]` ReadSet batches.

    Records parse and trim one at a time and accumulate to `batch_reads`
    (whole pairs: `batch_reads` must be even when `paired`); the final
    short batch pads with inert rows, so every batch has the same shape.
    Wrap in `repro_torch.stream.BatchSource` to re-iterate:

        src = BatchSource(lambda: iter_fastq_batches(path, ...))
    """
    if paired and batch_reads % 2:
        raise ValueError(
            f"batch_reads={batch_reads} must be even for paired input")
    if batch_reads < 1:
        raise ValueError(f"batch_reads={batch_reads} must be positive")
    pending = []
    for rec in iter_fastq_records(source):
        pending.append(quality_trim(*rec, trim_q))
        if len(pending) == batch_reads:
            yield _pack(pending, R=batch_reads, L=max_len, min_len=min_len,
                        paired=paired, insert_size=insert_size)
            pending = []
    if paired and len(pending) % 2:
        pending = pending[:-1]  # unmated trailing read
    if pending:
        yield _pack(pending, R=batch_reads, L=max_len, min_len=min_len,
                    paired=paired, insert_size=insert_size)


def write_fasta(seqs, names=None) -> str:
    """Render assembled pieces as FASTA text."""
    out = []
    for i, s in enumerate(seqs):
        name = names[i] if names else f"scaffold_{i}"
        out.append(f">{name}")
        s = s.cpu().numpy() if torch.is_tensor(s) else np.asarray(s)
        out.append("".join("ACGTN"[int(b)] for b in s))
    return "\n".join(out) + "\n"
