"""The benchmark's harness: it finds a cell's files by name, drives the
program (``lurk_tpu_torch``) through the cell's jobs, times the window,
reads the trace and hands the program's outputs to the plain reference
(``benchmark/reference``)."""
