"""The least time the card could take for what a frame needs of a group of
kernels: the larger of the bytes over the memory rate and the float
operations over the fp32 rate.

Only what the frame itself needs is counted, whatever implements it:
each input byte read once (a live ray's origin, direction and max_len;
the triangle records once per cast; the texture texels once per frame),
each output byte written once (a closest hit's s, u, v and triangle, an
any hit's flag, the MRT channels), and, per live ray, the operations of
one triangle test, and per hit the shading's. The program's own
intermediate layouts (state rows, worklist slots, triangle tiles) are not
counted. The live rays and hits come from the reference's casts of the
same frames (the reference renderer's `counting`), never from the program.

The rates and operation counts are a frozen copy of chip_smoke.py's
(counted there from csrc/'s sources): a later change to a kernel does not
change this yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12       # fp32 outside the tensor cores, same sheet
F32 = 4
RAY_IN = 7 * F32             # origin, direction, max_len
HIT_OUT = 4 * F32            # s, u, v, triangle
ANY_OUT = 1                  # hit or not
RECORD = 16 * F32            # a triangle's 16-float record
MRT_OUT = 18 * F32           # color 3, glass, original color 3, original w,
                             # render id 4, original id w, location id 4, alpha
# one record test that accepts its pair (chip_smoke.py OPS_REC_*): the ray's
# |d|^2 and d x o (12), det 6, sdet 7, u and v 2 x 18, the divide 4, the window 7
OPS_TEST = 12 + 6 + 7 + 2 * 18 + 4 + 7
# one bounce's shading of a hit (chip_smoke.py OPS_SHADE) and each light of
# its reservoir loop (OPS_LIGHT)
OPS_SHADE = 181
OPS_LIGHT = 148


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def casts_bytes(counts: dict, triangles: int) -> float:
    """Rays in and hits out of every cast, and the records once a cast."""
    casts = counts["closest_casts"] + counts["any_casts"]
    return (counts["closest_live"] * (RAY_IN + HIT_OUT) + counts["any_live"] * (RAY_IN + ANY_OUT)
            + casts * triangles * RECORD)


def tests_ops(counts: dict) -> float:
    return (counts["closest_live"] + counts["any_live"]) * OPS_TEST


def fused_bound_ms(counts: dict, shape: dict) -> float:
    """PRE, POST and POST's live lists (csrc/fused.cu) a frame: the casts,
    the shading of every hit, the texels and the MRT."""
    nbytes = (casts_bytes(counts, shape["triangles"]) + shape["texture_bytes"]
              + shape["pixels"] * MRT_OUT)
    ops = tests_ops(counts) + counts["closest_hits"] * (OPS_SHADE + shape["lights"] * OPS_LIGHT)
    return bound_ms(nbytes, ops)


def sparse_bound_ms(counts: dict, shape: dict) -> float:
    """The worklist casts (csrc/sparse.cu: flags, key, closest, any) a
    frame: the casts alone; shading runs outside them."""
    return bound_ms(casts_bytes(counts, shape["triangles"]), tests_ops(counts))


def per_frame(counts: dict, frames: int) -> dict:
    """The reference's cast records of `frames` MRT passes as per-frame
    means: live rays, hits and casts."""
    return {"closest_live": sum(counts["closest_live"]) / frames,
            "closest_hits": sum(counts["closest_hits"]) / frames,
            "any_live": sum(counts["any_live"]) / frames,
            "closest_casts": len(counts["closest_live"]) / frames,
            "any_casts": len(counts["any_live"]) / frames}
