"""Batched device compute kernels: elements, assembly, solver, material."""
