from .pipeline import MarkovSynthetic, SyntheticDataset, host_shard

__all__ = ["SyntheticDataset", "MarkovSynthetic", "host_shard"]
