"""Neural building blocks (NCHW modules) and, in ``ops.cuda``, the kernels."""
