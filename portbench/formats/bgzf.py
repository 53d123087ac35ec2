"""BGZF (htslib, gzp ``src/bgzf.rs``): members of at most 65,280 input
bytes, at most 65,536 bytes each, then the 28-byte EOF member. The plain reference is
``members.py``'s."""

from __future__ import annotations

from portbench.formats import members

PROGRAM = "Bgzf"  # the port's format object
FRAMING = members.BGZF
HALO = 0  # members carry no dictionary


def check(parts, want, threads=8):
    return members.check(FRAMING, parts, want, threads)


def write(data, level, block, threads=8):
    return members.write(FRAMING, data, level, block, threads)


def control(sink, cfg):
    """The control: the reference writer with every member's CRC32 left
    out (written as 0)."""
    return members.Writer(FRAMING, sink, cfg["level"], cfg["block_bytes"], cfg["rows"], crc=0)


def control_reader(stream, cfg):
    """The read control: the reference reader with each block's bytes left
    padded to the device's 65,536-byte row, not trimmed to its ISIZE."""
    return members.Reader(FRAMING, stream, cfg["rows"], pad=65536)
