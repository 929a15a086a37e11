"""Surface tour: views as operands, fused matmul epilogues, axis
reductions, and the int8 path.

Run: python examples/quantized_views.py   (any backend)
"""

import numpy as np

import simplemath_tpu as sm

rng = np.random.default_rng(0)

# --- views as operands -----------------------------------------------------
# The transpose below joins the deferred chain; XLA fuses it into the add.
A = sm.array(rng.standard_normal((1024, 512)).astype(np.float32))
B = sm.array(rng.standard_normal((512, 1024)).astype(np.float32))
C = sm.add(A.T, B)
print("view add:", C.shape)

# Pure transpose views feeding a contraction fold into dot_general
# dimension numbers — a.T @ b costs no relayout copy either.
P = A.T @ sm.array(rng.standard_normal((1024, 256)).astype(np.float32))
print("transposed matmul:", P.shape)

# --- axis reductions (fusable) ----------------------------------------------
row_norms = sm.fuse(lambda x: sm.sum(sm.square(x), axis=1))
print("row norms:", np.asarray(row_norms(A)).shape)

# --- fused matmul epilogue: relu(x @ W + b) is one program ------------------
X = rng.standard_normal((512, 384)).astype(np.float32)
W = rng.standard_normal((384, 640)).astype(np.float32)
b = rng.standard_normal((1, 640)).astype(np.float32)
layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
Y = layer(X, W, b)
print("fused layer:", Y.shape)

# --- quantized inference on the int8 path ----------------------------------
qx, sx = sm.quantize(X)
qw, sw = sm.quantize(W)
# scale= dequantizes the i32 product to f32 in the same program.
Yq = sm.int8_matmul(qx, qw, scale=float(np.asarray(sx) * np.asarray(sw)))
ref = X @ W
rel = np.abs(np.asarray(Yq) - ref).max() / np.abs(ref).max()
print(f"int8 layer rel err vs f32: {rel:.4f}")

# --- advanced indexing -----------------------------------------------------
hot = sm.array(np.asarray(Y))[np.asarray(Y).sum(axis=1).argsort()[-5:]]
print("top-5 rows by activation:", hot.shape)
