"""K8 (``csrc/suffix_merge.cu``): one launch per batch at levels 6-9.
Reads each content-sorted slot's position and its lag-1 common prefix and
the halo starts, writes a packed candidate per slot. Bound by bytes since
its redesign (its needed candidate tests at about 3 ALU instructions each
take less)."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, slots = s["rows"], s["rows"] * s["npad"]
    return [(2 * slots * 4 + 4 * b + slots * 4, 0)]
