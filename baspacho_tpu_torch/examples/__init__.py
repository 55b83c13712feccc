"""The port's twins of the JAX package's demos (examples/), runnable as
modules, on the CUDA card unless --device names another:

  python -m baspacho_tpu_torch.examples.optimize_simple
  python -m baspacho_tpu_torch.examples.optimize_ba [problem.txt[.gz]]
  python -m baspacho_tpu_torch.examples.diff_solve
  python -m baspacho_tpu_torch.examples.pcg_sample [jacobi|gauss_seidel]
"""
