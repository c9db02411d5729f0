"""The command line and REPL: ``python -m lurk_tpu_torch.cli``."""
