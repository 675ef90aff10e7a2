"""The port's copy of ``repro.configs``: ``ModelConfig`` and the
architecture configs, as data."""
