from .pipeline import DataConfig, Prefetcher, make_batch_specs, synthetic_batches
