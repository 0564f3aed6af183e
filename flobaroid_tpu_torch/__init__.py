"""flobaroid_tpu_torch — the PyTorch/CUDA port of flobaroid_tpu.

The JAX package (`flobaroid_tpu`) stays the reference; this package
re-implements its fixed-base streamed identification path
(simulate -> per-channel Grams -> OLS -> physically consistent SDP ->
reporting) on PyTorch tensors, with the Gram contraction running in a
hand-written CUDA kernel on NVIDIA Hopper (`ops/gram.py`,
`csrc/gram.cu`).

Module names follow the JAX package so each counterpart is easy to
find. Conventions of the port:
  * every entry point takes an explicit `device` ("cpu" or "cuda");
    nothing silently picks one,
  * the sample axis is a leading batch dimension (no vmap), chunked
    loops replace lax.scan,
  * random draws use explicit torch.Generators.

The numpy/scipy/xml-only modules of the JAX package (models/urdf.py,
models/geometry.py, utils/helpers.py, identification/least_squares.py)
are imported from `flobaroid_tpu` unchanged; `flobaroid_tpu/__init__.py`
imports nothing, so that does not load JAX.
"""

__version__ = "0.1.0"
