"""Examples of the PyTorch port (``totsu_tpu_torch``): the batch examples
of ``examples/`` (``mpc_qp``, ``nearestcorr_batch_sdp``,
``trajsweep_batch``), each runnable as a script (``python
examples_torch/mpc_qp.py [--cpu]``) or importable as
``examples_torch.<name>``. They import no ``jax``."""
