"""The benchmark's seeded FASTQ (``portbench/corpus/fastq.py``): the same
seed gives the same bytes whatever the threads, and every whole record is
four lines, a CASAVA 1.8 name with tiles and y rising, a 150-base read in
ACGT, a bare ``+`` and 150 qualities in NovaSeq's four bins."""

import re

from portbench.corpus import fastq

NAME = re.compile(rb"@A\d{5}:\d+:H[A-Z0-9]{5}DSX:(\d):(\d{4}):(\d+):(\d+) 1:N:0:[ACGT]{8}")
SEED = 2**31 + 4321


def test_same_seed_same_bytes_different_seed_different_bytes():
    a = fastq.make(3 << 20, SEED)
    assert len(a) == 3 << 20
    assert a == fastq.make(3 << 20, SEED, threads=1)
    assert a[: 1 << 20] == fastq.make(1 << 20, SEED)  # a prefix of the longer draw
    assert a != fastq.make(3 << 20, SEED + 1)


def test_records_are_four_lines_of_casava_fastq():
    lines = fastq.make(3 << 20, -SEED).split(b"\n")
    whole = len(lines) // 4 - 1  # the last record may be cut at the end
    assert whole > 8000
    last = (0, 0, 0)
    for r in range(whole):
        name, read, plus, qual = lines[4 * r: 4 * r + 4]
        m = NAME.fullmatch(name)
        assert m, name
        lane, tile, x, y = (int(g) for g in m.groups())
        assert lane == 1 and 1000 <= x < 32000 and 1000 <= y < 37000
        assert (lane, tile, y) >= last  # the file lists tiles in order, clusters by y
        last = (lane, tile, y)
        assert len(read) == len(qual) == fastq.READ
        assert set(read) <= set(b"ACGT") and set(qual) <= set(b"#-8F")
        assert plus == b"+"
    assert last[1] == fastq.TILES[(whole - 1) // fastq.TILE_READS]
