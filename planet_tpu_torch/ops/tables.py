"""Perlin permutation table and gradient set (planet_tpu ops/tables.py,
copied so the port imports nothing of planet_tpu).

These constants are law: bit-parity with the reference C build requires the
identical 256-entry permutation (reference perlin.h:10-28) and the identical
16 gradient directions (reference perlin.h:30-36).
"""

import numpy as np

# The exact 256-entry random permutation table (reference perlin.h:10-28).
PERLIN_TABLE = np.array([
    211, 222,  90,  42, 136,  37, 204, 126,  22, 101, 213, 137, 251,  28, 247, 205,
    185, 176, 200, 206, 243, 130, 252, 188,  19, 235, 231,   1, 170, 109,  11,  31,
     58, 134, 230, 148,  65, 184, 250, 226, 129, 197, 135,  99, 201,   5,  40, 220,
    132, 218,  15, 110, 120, 239, 151,  35, 141,  70, 217,   7, 107, 150, 178, 162,
    160,  93, 164, 118, 174,  29,  45,  84, 207,  81,   8,  64,  43, 244, 203,  67,
     95,  25,  69,   3, 183, 242,  94, 172, 121, 144, 122, 249,  61, 159, 240,  59,
    193, 157, 224,  52,  71, 112,  32, 167, 155, 165, 177, 255,  78,  10,  26, 149,
    124, 133, 140, 189, 233,  60,  96, 254,  50, 236, 131, 215,  49,  79,  54, 214,
    196, 104, 234,  18, 181,  53, 152, 116, 127,  30, 182,   6,  98, 146, 208, 102,
    221, 241,  48, 228,  73,  82, 245, 142, 105,  80,  34, 246,  23, 139, 238,  97,
     51, 190, 186, 232,  44,  91,  87, 173,  16, 168,  46,  75, 199, 138, 198,  33,
     24,  66, 225, 195, 169, 100,  88, 237,  38,  57,   0,   4,  86,  14, 253, 115,
     47, 212, 180, 171, 163,  63, 194, 227, 210,  62,  12,  89, 161, 192,  39, 166,
    128, 123,  17, 223, 106, 117, 229, 108,  76, 145, 125, 219, 175,  36, 202, 114,
    153,  72, 209,  27,  83,  85,  13,  68, 147, 158, 187, 179, 156, 154,  56,  77,
     20, 143, 119, 103, 113, 191,   9,  41,  74, 216,   2, 111,  21,  92, 248,  55,
], dtype=np.int32)

# The 16 gradient directions (reference perlin.h:30-36). Components are all
# in {-1, 0, 1}, so a gradient dot product needs only sign-selected adds.
PERLIN_VECTORS = np.array([
    [ 1,  1,  0], [-1,  1,  0], [ 1, -1,  0], [-1, -1,  0],
    [ 1,  0,  1], [-1,  0,  1], [ 1,  0, -1], [-1,  0, -1],
    [ 0,  1,  1], [ 0, -1,  1], [ 0,  1, -1], [ 0, -1, -1],
    [ 1,  1,  0], [-1,  1,  0], [ 0, -1,  1], [ 0, -1, -1],
], dtype=np.float32)


def fused_gradient_tables():
    """The last hash stage folded into the gradient choice: three 256-entry
    sign tables SX[s] = PERLIN_VECTORS[PERLIN_TABLE[s] & 15][0] (and SY,
    SZ), so grad = SX[s]*x + SY[s]*y + SZ[s]*z with
    s = (t[t[ix]+iy]+iz) & 255 (reference hash, perlin.h:43-48)."""
    idx = PERLIN_TABLE & 15
    g = PERLIN_VECTORS[idx]  # (256, 3)
    return g[:, 0].copy(), g[:, 1].copy(), g[:, 2].copy()
