"""Micro-benchmarks of the dequant-matmul design space on the H100: the
counterparts of the JAX package's ``tools/`` probes, one module per probe
file under the same name (``qmm_group_i8``, ``qmm_variants``, ``qmm_v3``,
``qmm_r3``, ``unpack_variants``, ``probe_int4``, ``probe_i8ops``), each run
as ``python -m minigpt4_tpu_torch.tools.<name>`` with its JAX file's flags
plus ``--device``.  Their kernels and plain versions are in
``minigpt4_tpu_torch/ops/probes.py``.  ``train_draft`` is the counterpart
of ``tools/train_bench_draft.py``: it distills a draft head against a
llama.cpp file (``train/draft.py``)."""
