"""Examples of the PyTorch port (``totsu_tpu_torch``): every example of
``examples/``, each runnable as a script (``python
examples_torch/<name>.py [--cpu]``; ``run_all.py`` runs them all) or
importable as ``examples_torch.<name>`` with ``main(..., cpu=None)``.
``--cpu`` runs on the CPU in f64, the default is the CUDA card in f32.
They import no ``jax``; ``--plot`` needs matplotlib (``_plot.py``)."""
