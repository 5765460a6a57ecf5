"""The paper's experiments on the port: the counterparts of ``repro``'s
``benchmarks/fig1_speedup.py``, ``fig2_reference.py``,
``fig3_tradeoff.py``, ``fig4_windowed.py``, ``fig5_sharded.py``,
``fig6_streaming.py``, ``fig7_serving.py`` and ``fig10_session.py``, one
module each under the same name, and ``run.py``, which runs the eight
and writes their ``BENCH_<fig>.json`` artifacts.  ``fig5_sharded`` runs
each rank count's ranks as subprocesses of a ``torch.distributed``
group.

    python -m repro_torch.figures.fig1_speedup [--smoke | --full] [--device cuda|cpu]
    python -m repro_torch.figures.run [--smoke | --full] [--device cuda|cpu] [--out-dir DIR]

Each keeps ``repro``'s ``setup`` / ``run`` / ``main(fast_mode)`` shape,
its ``name,us_per_call,derived`` CSV rows, sweep sizes, seeds and gates
(a figure raises on a failed gate).  On the card the kernel rows launch
the CUDA kernels; with ``--device cpu`` they run the kernels' plain
PyTorch versions, as every kernel wrapper does on CPU tensors.  Every
time is taken between two ``torch.cuda.synchronize()`` calls on the card
and printed below a line naming the card and its power limit.  (Named
``figures``, not ``benchmarks``: this is not the repository's
benchmark.)
"""
