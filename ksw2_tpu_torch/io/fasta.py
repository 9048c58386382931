"""FASTA/FASTQ streaming reader (kseq.h equivalent).

Supports plain and gzip files, multi-line records, FASTA ('>') and FASTQ
('@') with name/comment/seq/qual — the same record model as the reference's
``kseq_read`` (kseq.h:177-218).  The port's own copy of
``ksw2_tpu/io/fasta.py``, its pure-Python path.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, Optional


@dataclasses.dataclass
class SeqRecord:
    name: str
    comment: str
    seq: str
    qual: Optional[str] = None


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Yield records from a FASTA/FASTQ file (optionally gzipped)."""
    with _open(path) as f:
        name = comment = None
        seq_parts = []
        is_fastq = False
        line_iter = iter(f)
        for line in line_iter:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line[0] in ">@":
                if name is not None:
                    yield SeqRecord(name, comment or "", "".join(seq_parts))
                header = line[1:].split(None, 1)
                name = header[0] if header else ""
                comment = header[1] if len(header) > 1 else ""
                seq_parts = []
                is_fastq = line[0] == "@"
            elif line[0] == "+" and is_fastq:
                seq = "".join(seq_parts)
                qual_parts = []
                qlen = 0
                for qline in line_iter:
                    qline = qline.rstrip("\n").rstrip("\r")
                    qual_parts.append(qline)
                    qlen += len(qline)
                    if qlen >= len(seq):
                        break
                yield SeqRecord(name, comment or "", seq, "".join(qual_parts))
                name = None
                seq_parts = []
            else:
                seq_parts.append(line)
        if name is not None:
            yield SeqRecord(name, comment or "", "".join(seq_parts))


__all__ = ["SeqRecord", "read_fastx"]
