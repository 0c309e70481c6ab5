"""Multi-GPU rendering over torch.distributed (twin of rustic_tpu/parallel).

Paths are independent, so the design is data parallel, one process a
rank:

- mesh axes ('px', 'spp'): the pixel list shards over 'px', the sample
  range over 'spp',
- the scene is replicated (read-only, small): every rank holds a copy on
  its own device,
- each rank integrates its (pixel shard x sample share) block with the
  single-device renderer; the only collectives are one all-reduce of
  the film sums over 'spp' and one all-gather of the shards over 'px'.
"""

from rustic_tpu_torch.parallel.shard import (  # noqa: F401
    make_mesh,
    render_sharded,
    sharded_step,
)
