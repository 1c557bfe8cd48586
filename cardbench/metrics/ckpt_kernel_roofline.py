"""Kernels (``kernels/checksum.py``, ``fused.py``,
``csrc/ckpt_kernels.cu``): the bytes the window's checkpoint kernels must
read and write, from the saves' footers (a raw tensor's digest reads it
once; an XOR delta reads the state and its base and writes the delta; an
int8 encode reads the state and writes its payloads), over the card's
memory rate, over their summed device time in the trace, in %."""

import math

from cardbench import flops, reader
from cardbench.window import kernel_seconds

KERNELS = ("checksum_segments_kernel", "xor_checksum_kernel",
           "quantize_segments_kernel", "dequantize_segments_kernel",
           "quantize_int8_kernel", "dequantize_int8_kernel",
           "stream_kernel", "stream_tma_kernel")


def kernel_bytes(root, steps):
    total = 0
    for step in steps:
        for f in reader.step_files(root, step):
            for t in f.tensors.values():
                codec = t["codec"].split("+", 1)[0]
                if codec == "raw" and t.get("raw_chunks"):
                    total += t["nbytes"] + 4 * len(t["raw_chunks"])
                elif codec == "xor":
                    total += 3 * t["nbytes"]
                elif codec == "int8q":
                    total += t["nbytes"] + sum(
                        8 + (4 + reader.ROW_ELEMS) * math.ceil(
                            (c[3] - c[2]) / (4 * reader.ROW_ELEMS))
                        for c in t["enc_chunks"])
    return total


def read(run):
    if not run.summary or not run.futures:
        return None
    n, s = kernel_seconds(run.summary["kernels"], *KERNELS)
    if not n or s <= 0:
        return None
    nbytes = kernel_bytes(run.ckpt_root, [f.step for f in run.futures])
    least = nbytes / flops.peaks(run.kind)["hbm_bytes_per_s"]
    return 100.0 * least / s
