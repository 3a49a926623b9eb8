"""Model configurations of the port: the same plain-data ``ModelConfig``
records and registry as the reference package's ``configs`` (the
per-model files are copies).  The dry-run shape tables (``shapes.py``) are
not ported yet."""
from .base import ModelConfig, all_configs, get_config, register
