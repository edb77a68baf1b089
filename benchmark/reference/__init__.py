"""Plain references of popgenWindows' analyses, one module an
``--analysis`` value (``reference/<analysis>.py``), on plain PyTorch and
NumPy.  They import nothing of the port and nothing of JAX, and take only
the genotype codes the benchmark generated."""
