"""The plain float32 reference that decides ``correct``, and its control.

Plain PyTorch, TF32 off, no kernels, no cache, no batching: one model's
full causal forward over each checked sequence (its prompt and the
tokens the program served), layer by layer, from weights the benchmark
makes again from the seed (``muxbench/weights.py``).  It imports nothing
of the program, of ``repro`` or of ``jax``.  One module a family, named
by a configuration file's ``reference`` key: ``dense`` (GQA decoder with
QKV bias, RoPE, SwiGLU) and ``mamba2`` (the SSD mixer, Dao & Gu 2024).
"""
