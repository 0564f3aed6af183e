"""flobaroid_tpu_torch — the PyTorch/CUDA port of flobaroid_tpu.

The JAX package (`flobaroid_tpu`) stays the reference; this package
re-implements its fixed-base streamed identification path
(simulate -> per-channel Grams -> OLS -> physically consistent SDP ->
reporting) on PyTorch tensors, with the Gram contraction running in a
hand-written CUDA kernel on NVIDIA Hopper (`ops/gram.py`,
`csrc/gram.cu`).

Module names follow the JAX package so each counterpart is easy to
find. Conventions of the port:
  * every entry point runs on the card (`device="cuda"`) unless the
    caller asks for the CPU (`device="cpu"`); "cuda" without a card
    raises, with no CPU fallback,
  * the sample axis is a leading batch dimension (no vmap), chunked
    loops replace lax.scan,
  * random draws use explicit torch.Generators.

The port imports neither JAX nor anything of `flobaroid_tpu`: it keeps
its own copies of the numpy/scipy/xml-only code it needs
(`models/urdf.py`, `models/geometry.py`, `utils/helpers.py`,
`identification/least_squares.py`, `output.py`, `robot_io/`). Only its
tests import both packages. The command line is `cli/`, one module per
root script of the JAX package (`python -m flobaroid_tpu_torch.cli.<name>`);
`tools/` and `examples/` are the port's copies of the JAX package's tools
and examples, and `parallel/` shards samples and candidates over devices
in one process (`shardSamples`, `shardCandidates`).
"""

__version__ = "0.1.0"
