"""A run's comparison with the plain reference fails each fault the timed
path can have, and the control; a sound run passes. Each drives the rest
of a run (``portbench.run.run``) on the CPU at a size a test can hold,
skipping only the look for a card."""

import pytest

import gzp_tpu_torch.parallel.compress as pc
import gzp_tpu_torch.parallel.decompress as pd
from gzp_tpu_torch import check as checks
from portbench import harness
from portbench import run as runner

WRITE_CELLS = ["mgzip-l3.text", "bgzf-l6.text", "gzip-l3.stream"]
READ_CELL = "bgzf-l6.read-device"


def _run(name, control=False):
    cell = harness.load_cell(name)
    if cell.traffic["driver"] == "read":  # K11's plain version is slow on the CPU
        cell.config["rows"] = 8
        cell.traffic.update(corpus_bytes=3 * 65280, warmup_batches=1, keep_bytes=1 << 20)
    else:
        cell.config["rows"] = 2
        cell.traffic.update(corpus_bytes=1 << 20, warmup_batches=1, keep_bytes=1 << 24)
    return runner.run(runner.Ctx(cell, 2**31 + 1234, 0.5, False, "cpu", control))


def _flip_device_output(monkeypatch):
    """A byte of each batch's encoded output altered where the encoder
    produces it."""
    orig = pc.MeshEncoder.__call__

    def altered(self, *arrays):
        res = orig(self, *arrays)
        res[0]["flat"][100] ^= 1
        return res
    monkeypatch.setattr(pc.MeshEncoder, "__call__", altered)


def _drop_half_the_batch(monkeypatch):
    orig = pc.ParCompress._stitch_batch
    monkeypatch.setattr(pc.ParCompress, "_stitch_batch",
                        lambda self, get, chks, arr, lengths, finals, count:
                        orig(self, get, chks, arr, lengths, finals, max(1, count // 2)))


def _check_state_unchanged(monkeypatch):
    """The stream's running CRC32 left as it was (no block combined)."""
    monkeypatch.setattr(checks.Crc32, "combine_sum", lambda self, value, length: None)


WRITE_FAULTS = {"altered": _flip_device_output, "half": _drop_half_the_batch,
                "state": _check_state_unchanged}


@pytest.mark.parametrize("cell", WRITE_CELLS)
def test_sound_write_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["compared"].values())
    assert list(line)[-1] == "compared"


# members carry no running stream check (each has its own CRC32): the
# state fault is the stream's alone
@pytest.mark.parametrize("cell,fault", [(c, f) for c in WRITE_CELLS for f in sorted(WRITE_FAULTS)
                                        if f != "state" or c == "gzip-l3.stream"])
def test_write_fault_is_not_correct(cell, fault, monkeypatch):
    WRITE_FAULTS[fault](monkeypatch)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", WRITE_CELLS + [READ_CELL])
def test_control_is_not_correct(cell):
    line = _run(cell, control=True)
    assert not line["correct"]


def test_sound_read_run_is_correct():
    line = _run(READ_CELL)
    assert line["correct"], line["compared"]


def _altered_read(self):
    out = bytearray(ORIG_RESULT(self))
    out[len(out) // 2] ^= 1
    return bytes(out)


def _half_read(self):
    out = ORIG_RESULT(self)
    return out[: len(out) // 2]


ORIG_RESULT = pd._DeviceBatch.result


@pytest.mark.parametrize("fault", [_altered_read, _half_read], ids=["altered", "half"])
def test_read_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(pd._DeviceBatch, "result", fault)
    assert not _run(READ_CELL)["correct"]
