"""Data-parallel rendering over torch.distributed (twin of
rustic_tpu/parallel/shard.py).

One process a rank, as torchrun starts them; the JAX package runs one
controller over a jax.sharding.Mesh with shard_map. The world's ranks
form a ('px', 'spp') mesh in rank order: the padded pixel list splits
over 'px' into contiguous shards, the sample range over 'spp'. Each rank
renders its share of its shard on its own device with the single-device
renderer, the 'spp' peers sum their film sums (one all-reduce), and the
'px' shards are gathered in rank order (one all-gather). The scene is
replicated: every rank holds its own copy on its device.

Without an initialized process group the mesh is a world of one on this
process's device, and every collective is the identity. With one, every
collective runs, also over an axis of size 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from rustic_tpu_torch.config import RenderSettings, StaticConfig, TracingConfig
from rustic_tpu_torch.runtime.render import (
    pixel_offsets,
    pixel_tensor,
    render_lanes,
    render_pixels,
    resolve_device,
    u32_bits,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks laid out over named axes, and this rank's device.

    `shape` maps each axis name to its size, in axis order (rank r sits at
    the row-major coordinate of r); `device_mesh` is None in a world of
    one without a process group."""

    shape: dict
    device: torch.device
    device_mesh: Optional[object] = None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 on an axis the mesh lacks)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's peers along `axis`, or None
        where there is nothing to communicate with."""
        if self.device_mesh is None or axis not in self.shape:
            return None
        return self.device_mesh.get_group(axis)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple:
    """(world size, this rank) of the default process group, or (1, 0)."""
    if _initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_device(devices) -> torch.device:
    world, rank = _world()
    if devices is None:
        device = resolve_device("cuda")
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of {world} ranks: "
                             "name one device a rank, in rank order")
        device = resolve_device(devices[rank])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _mesh(shape: dict, devices) -> Mesh:
    device = _rank_device(devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before the groups, which bind to it
    if not _initialized():
        return Mesh(shape, device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, tuple(shape.values()), mesh_dim_names=tuple(shape))
    return Mesh(shape, device, dm)


def make_mesh(devices=None, spp_parallel: Optional[int] = None) -> Mesh:
    """A ('px', 'spp') mesh over the world's ranks.

    `devices`: each rank's render device, in rank order (one a rank); by
    default every rank renders on its current CUDA device. `spp_parallel`
    is how many ranks split the sample range (default: 2 when the world is
    even and larger than 1, else 1); the rest split the pixels. Creating
    a mesh is collective: every rank makes the same meshes in the same
    order."""
    n = _world()[0]
    if spp_parallel is None:
        spp_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if spp_parallel < 1 or n % spp_parallel:
        raise ValueError(f"spp_parallel {spp_parallel} does not divide the world of {n} ranks")
    return _mesh({"px": n // spp_parallel, "spp": spp_parallel}, devices)


def make_px_mesh(devices=None) -> Mesh:
    """A one-axis ('px',) mesh over the world's ranks: pixels only, the
    layout of `render_sharded_staged` by default. `devices` as in
    `make_mesh`."""
    return _mesh({"px": _world()[0]}, devices)


def _sample_share(mesh: Mesh, n_samples: int) -> tuple:
    """(first sample offset, samples) of this rank's 'spp' share; every
    rank raises alike, before any collective, when they do not divide."""
    spp = mesh.size("spp")
    if n_samples % spp:
        raise ValueError(f"{n_samples} samples do not split over the {spp} ranks of 'spp'")
    local = n_samples // spp
    return mesh.index("spp") * local, local


def _sum_spp(mesh: Mesh, film: torch.Tensor) -> torch.Tensor:
    group = mesh.group("spp")
    if group is not None:
        dist.all_reduce(film, group=group)
    return film


def sharded_step(mesh: Mesh, cfg: StaticConfig, n_samples: int, engine: str = "auto"):
    """One render step over this rank's pixel shard.

    Returns fn(scene, cam, px, py, offsets, sample_start, film_in) ->
    film_in + the film sums [b, 3] of the shard: px, py, offsets (int32,
    u32 bits) and film_in on the scene's device. Each 'spp' peer renders
    n_samples / |spp| samples from sample_start + its 'spp' index times
    that count (u32 arithmetic, as the sample index is everywhere) through
    `render_lanes` with `engine`, and the peers' film sums are all-reduced
    before film_in is added."""
    first, local = _sample_share(mesh, n_samples)

    def step(scene, cam, px, py, offsets, sample_start, film_in):
        start = (int(sample_start) + first) & 0xFFFFFFFF
        film = render_lanes(scene, cfg, cam, px, py, offsets, start, local, engine=engine)
        return film_in + _sum_spp(mesh, film)

    return step


def assemble_film(film_local, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The frame's film from the 'px' shards, as a numpy array: the shards
    all-gathered in rank order over the mesh's 'px' group (the whole world
    when `mesh` is None), the counterpart of the JAX package's
    process_allgather. Without a process group it is the identity."""
    if mesh is None:
        if not _initialized():
            return _numpy(film_local)
        group, n = None, dist.get_world_size()
    else:
        if mesh.device_mesh is None:
            return _numpy(film_local)
        group, n = mesh.group("px"), mesh.size("px")
    film = torch.as_tensor(film_local).contiguous()
    parts = [torch.empty_like(film) for _ in range(n)]
    dist.all_gather(parts, film, group=group)
    return torch.cat(parts).cpu().numpy()


def _numpy(film) -> np.ndarray:
    return film.detach().cpu().numpy() if isinstance(film, torch.Tensor) else np.asarray(film)


def _pixel_shard(config: TracingConfig, settings: RenderSettings, mesh: Mesh):
    """The frame's pixels padded to whole 'px' shards (as the JAX
    package's np.pad: pixel (0, 0) with offset 0, cut off after the
    gather) -> (pixels in the frame, px, py, offsets of this rank's
    contiguous shard)."""
    w, h = config.width, config.height
    n_px = w * h
    pad = (-n_px) % mesh.size("px")
    y, x = np.mgrid[0:h, 0:w]
    px = np.pad(x.reshape(-1).astype(np.int32), (0, pad))
    py = np.pad(y.reshape(-1).astype(np.int32), (0, pad))
    offsets = np.pad(pixel_offsets(w, h, settings.use_blue_noise), (0, pad))
    b = len(px) // mesh.size("px")
    lo = mesh.index("px") * b
    return n_px, px[lo:lo + b], py[lo:lo + b], offsets[lo:lo + b]


def _frame(film: torch.Tensor, n_px: int, config: TracingConfig, settings: RenderSettings,
           mesh: Mesh) -> np.ndarray:
    film = assemble_film(film, mesh)[:n_px] / max(settings.samples, 1)
    return film.reshape(config.height, config.width, 3)


def _on_mesh(scene, mesh: Optional[Mesh], make) -> tuple:
    if mesh is None:
        mesh = make([scene.device] * _world()[0])
    if scene.device != mesh.device:
        scene = scene.to(mesh.device)
    return scene, mesh


def render_sharded(
    scene,
    config: TracingConfig,
    settings: Optional[RenderSettings] = None,
    mesh: Optional[Mesh] = None,
    engine: str = "auto",
) -> np.ndarray:
    """The full frame over the mesh (default: `make_mesh` over the scene's
    device on every rank): this rank's pixel shard through `sharded_step`
    with `engine`, then the gather. Every rank returns the mean film
    [H, W, 3]."""
    settings = settings or RenderSettings()
    scene, mesh = _on_mesh(scene, mesh, make_mesh)
    step = sharded_step(mesh, config.static_part(), settings.samples, engine)
    n_px, px, py, offsets = _pixel_shard(config, settings, mesh)
    dev = mesh.device
    film = step(
        scene, config.dynamic_part(dev), pixel_tensor(px, dev), pixel_tensor(py, dev),
        u32_bits(offsets, dev), 0, torch.zeros((len(px), 3), dtype=torch.float32, device=dev),
    )
    return _frame(film, n_px, config, settings, mesh)


def render_sharded_staged(
    scene,
    config: TracingConfig,
    settings: Optional[RenderSettings] = None,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """The full frame over the mesh (default: `make_px_mesh` over the
    scene's device on every rank) through the staged pipeline: this rank's
    pixel shard and 'spp' share of the samples through `render_pixels`
    with engine=None and the loops and scan form `settings` names, the
    'spp' all-reduce, then the gather. Every rank returns the mean film
    [H, W, 3]."""
    settings = settings or RenderSettings()
    scene, mesh = _on_mesh(scene, mesh, make_px_mesh)
    first, local = _sample_share(mesh, settings.samples)
    n_px, px, py, offsets = _pixel_shard(config, settings, mesh)
    film = render_pixels(
        scene, config, px, py, local, offsets=offsets, sample_start=first,
        loop=settings.multitile_loop, scan=settings.multitile_scan,
        single_loop=settings.single_tile_loop, engine=None,
    )
    return _frame(_sum_spp(mesh, film), n_px, config, settings, mesh)
