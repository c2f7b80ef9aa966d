"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's layout (``paddle_tpu/serving/
engine.py`` -> ``paddle_tpu_torch/serving/engine.py``) and imports
``torch`` and numpy only. What is ported so far is the serving main
path: a Llama decoder served through the ragged engine step, with the
ragged paged attention kernel written by hand in CUDA for Hopper
(``csrc/ragged_paged_attention.cu``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.
"""
__version__ = "0.1.0"
