"""The benchmark's general code: it finds a cell's configuration, traffic
mix and metric readers by the names in ``BENCHMARK.json``, makes the
inputs from the seed, drives the program through one window, and judges
what the window produced against ``reference``."""
