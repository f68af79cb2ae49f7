"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of Fed3R.

``perfbench/run.py`` runs one cell of ``BENCHMARK.json`` once on the card.
Everything that belongs to one cell, configuration, traffic mix, driver,
reference or per-layer metric is a file of its own here, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the federation's parameters, read by
  :mod:`perfbench.federation`, and the driver that runs it;
* ``workloads/<cell>.json``: the limit of each number the cell's
  correctness check compares;
* ``drivers/<driver>.py``: the timed loop of one kind of work;
* ``families/<family>.py``: the program's side of one model family (its
  inputs, weights and the port's feature path);
* ``reference/<family>.py``: the plain reference of that family, which
  imports nothing of the port;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick (traffic generation, peaks, operation and byte counts, the
references and the comparison) lives here, where the program cannot change
it.  Nothing here imports JAX or the JAX package ``repro``.
"""
