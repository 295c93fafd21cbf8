"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-class LM for
a few hundred steps with the full substrate (config registry, data
pipeline, AdamW, checkpointing).  Loss must drop: the synthetic corpus
has learnable motifs.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps N] \
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

sys.exit(main(["--arch", "qwen2.5-3b", "--smoke",
               "--steps", "200", "--batch", "8", "--seq", "128",
               "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                          "repro_torch_lm_ckpt")]
              + sys.argv[1:]))
