"""Host-side data pipeline of the port (misonet_tpu/data): extraction,
shards and batches, synthetic corpora, wav I/O."""

from misonet_tpu_torch.data.dataset import Batcher, ShardDataset
from misonet_tpu_torch.data.synthetic import synth_mixture, synth_shard_dir

__all__ = ["Batcher", "ShardDataset", "synth_mixture", "synth_shard_dir"]
