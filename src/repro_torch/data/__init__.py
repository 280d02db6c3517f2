from .pipeline import DataConfig, Loader, SyntheticSource
