"""Excitation trajectories: families, the D-optimality objective, the
optimizer and the suspended-base integrator."""
