"""Command-line entry points of the port, one module per root script of
the JAX package (trajectory, simulator, identifier, visualizer, excite,
gui). Each module has `main(argv=None)` and runs as
`python -m flobaroid_tpu_torch.cli.<name>`; the work runs on the card
unless `--device cpu` is given."""
