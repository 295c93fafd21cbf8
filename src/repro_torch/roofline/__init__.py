"""Roofline terms and analytic FLOP models of every (arch, shape) cell
(twin of ``repro.roofline``), at the NVIDIA H100's rates."""
