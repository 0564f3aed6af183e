"""Command-line tools of the port, one module per tool of the JAX
package's `tools/` that imports it (createNoisyURDF, scaleInertia,
paramErrorPlot, csv2npz, getMaxInertia). Each module has
`main(argv=None)`, takes the JAX tool's arguments and runs as
`python -m flobaroid_tpu_torch.tools.<name>`; the tools that compute on
a device (csv2npz's torque resimulation, getMaxInertia) take `--device`,
default `cuda`."""
