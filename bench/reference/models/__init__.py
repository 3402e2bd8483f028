"""The reference's model families, one module each, found by the
configuration file's ``family``: ``nll_sum(weights, tokens, targets,
cfg, mode)``."""
