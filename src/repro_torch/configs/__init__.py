"""Model configurations of the port: the same plain-data ``ModelConfig``
records and registry as the reference package's ``configs`` (the
per-model files are copies) and the assigned shapes with their data-input
specs (``shapes.py``)."""
from .base import ModelConfig, all_configs, get_config, register
from .shapes import SHAPES, Shape, cells, input_specs
