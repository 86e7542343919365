"""One module per estimator that a traffic file can name (its
``"estimator"`` key): ``setup(op, cfg, traffic, probe_seed, timer)``
builds the estimator's state with the program's own set-up functions and
returns an object with the window's ``step``."""
