"""The model families the benchmark runs, one module each, found by the
configuration file's ``family``: ``KEYS`` (the keys its files hold),
``leaf_specs(cfg)`` (the weight tree in the program's flat order, which
``bench.weights`` draws) and ``port_config(cfg)`` (the program's
ModelConfig of the file). The reference's side of a family is
``bench/reference/models/<family>.py``."""
