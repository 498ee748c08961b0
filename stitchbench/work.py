"""The benchmark's own counts of operations and bytes, from a cell's shapes.

Nothing here reads the program's plan or its cost models, so a change to
the plan cannot change the yardstick.  Peaks are one H100 SXM's published
dense rates (NVIDIA's data sheet, 700 W): float32 outside the tensor cores,
bfloat16 on them, and HBM3 bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass

#: operations a second of the configuration's type: float32 FMA outside
#: the tensor cores, bfloat16 dense on them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Work:
    """What one call of a program needs: the operations of its library
    products (``gemm_flops``, with ``gemm_bytes`` each operand read once and
    each result written once), and of the rest (``fused_flops`` as the
    program's outputs need them, ``fused_bytes`` read once and written
    once), with the rest's operations as a dense kernel would compute them
    (``fused_flops_dense``)."""

    tokens: int
    gemm_flops: float
    gemm_bytes: float
    fused_flops: float
    fused_flops_dense: float
    fused_bytes: float
    peak_flops: float = PEAK_FLOPS["float32"]

    @property
    def flops(self) -> float:
        """Every operation the call needs."""
        return self.gemm_flops + self.fused_flops


def gemm_flops(m: int, k: int, n: int) -> float:
    """Operations of an (m, k) x (k, n) product: a multiply and an add each."""
    return 2.0 * m * k * n


def gemm_bytes(m: int, k: int, n: int, itemsize: int = 4) -> float:
    """Bytes of an (m, k) x (k, n) product: both operands read, the result
    written."""
    return float(itemsize * (m * k + k * n + m * n))


def causal_attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """Operations of ``softmax(q kT) v`` under a causal mask as the outputs
    need them: query i attends to i + 1 keys, two products of head_dim
    each, so 2 * 2 * head_dim * T(T+1)/2 per head."""
    return 2.0 * batch * heads * head_dim * seq * (seq + 1)


def dense_attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """The same two products over every (query, key) pair, masked or not."""
    return 4.0 * batch * heads * seq * seq * head_dim


def seconds_at_roofline(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time one H100 could take: operations at ``peak_flops`` or
    bytes at HBM bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def decoder_stack(cfg: dict, batch: int, seq: int) -> Work:
    """One request through the stack of ``programs/decoder_layer.py``: every
    layer this chip holds, at the sizes it holds (``shape``).

    Library products: the q, k, v and output projections, and the gate, up
    and down projections where the layer has a gated MLP.  The rest of the
    attention sublayer (the norm, RoPE, the causal attention, the residual)
    reads ``x``, the gain, the RoPE tables and the projections' outputs
    (q, k, v and o @ Wo) and writes the normed ``h``, the merged heads
    ``o`` and its output; the rest of the MLP sublayer (the norm, SiLU of
    the gate times the up, the residual) reads the attention's output, the
    gain and the projections' outputs and writes its normed ``h``, the
    product ``m`` and ``y``."""
    from stitchbench.programs.decoder_layer import shape

    s = shape(cfg)
    d, hd, layers, dtype = s["d"], s["head_dim"], s["layers"], s["dtype"]
    qd, kvd, heads = s["heads"] * hd, s["kv_heads"] * hd, s["heads"]
    n = batch * seq
    shapes = [(n, d, qd), (n, d, kvd), (n, d, kvd), (n, qd, d)]
    elems = (n * d + d + 2 * seq * hd                 # x, g, cos, sin
             + n * qd + 2 * n * kvd + n * d           # q, k, v, o @ Wo
             + n * d + n * qd + n * d)                # h, o, its output
    if "ff" in s:
        ff = s["ff"]
        shapes += [(n, d, ff), (n, d, ff), (n, ff, d)]
        elems += (n * d + d + 2 * n * ff + n * d      # x, g2, gate, up, m @ Wd
                  + n * d + n * ff + n * d)           # h, m, y
    size = ITEMSIZE[dtype]
    return Work(
        tokens=n,
        gemm_flops=layers * sum(gemm_flops(*sh) for sh in shapes),
        gemm_bytes=layers * sum(gemm_bytes(*sh, itemsize=size) for sh in shapes),
        fused_flops=layers * causal_attention_flops(batch, heads, seq, hd),
        fused_flops_dense=layers * dense_attention_flops(batch, heads, seq, hd),
        fused_bytes=float(layers * size * elems),
        peak_flops=PEAK_FLOPS[dtype],
    )
