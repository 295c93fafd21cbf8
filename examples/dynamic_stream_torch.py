"""Temporal-stream scenario on the PyTorch/CUDA port: the paper's §5.1.4
evaluation protocol with fault-tolerant restart.  Kill it mid-stream and
re-run: it resumes from the last checkpoint.

    PYTHONPATH=src python examples/dynamic_stream_torch.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""
import sys

from repro_torch.launch.pagerank import main

sys.exit(main([
    "--dataset", "sx-mathoverflow",
    "--method", "frontier_prune",
    "--batch-frac", "1e-3",
    "--batches", "12",
    "--ckpt-every", "4",
    "--check-error",
] + sys.argv[1:]))
