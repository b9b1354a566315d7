"""The synthetic LiDAR world and its scans, made on the device from seeds.

A torch copy of the port's io/synthetic.py (itself the JAX package's), so
set-up makes the world and every scan on the card in a few large calls
instead of a numpy loop on the host. The distributions are the same: an
undulating ground, vertical pillars and wall segments; a scan at a pose
is the world's points between min_range and max_range, a random subset of
at most `raw_points` of them, in the sensor frame, with Gaussian noise.
The random streams are torch's, so a world here is not bit-equal to the
numpy one of the same seed.
"""

from __future__ import annotations

import math

import torch

PAD = 1.0e6  # what an unused raw lane holds (as the port's smoke run)
_SEED_MIX = 1_000_003


def generator(device, *seeds: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from whole numbers of any size."""
    s = 0
    for x in seeds:
        s = (s * _SEED_MIX + int(x)) % (2 ** 63 - 1)
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def build_world(gen: torch.Generator, device, extent: float, n_ground: int,
                n_pillars: int, n_walls: int, pillar_points: int = 600,
                wall_points: int = 2500) -> torch.Tensor:
    """(M, 3) float32 world surface points (io/synthetic.py's layout)."""
    f64 = torch.float64

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device, dtype=f64)

    gxy = (u(n_ground, 2) * 2.0 - 1.0) * extent
    gz = 0.05 * torch.sin(gxy[:, 0] * 0.15) * torch.cos(gxy[:, 1] * 0.11)
    ground = torch.cat([gxy, gz[:, None]], 1)
    c = (u(n_pillars, 2) * 2.0 - 1.0) * extent
    r = 0.2 + 0.6 * u(n_pillars, 1)
    h = 2.0 + 4.0 * u(n_pillars, 1)
    th = 2.0 * math.pi * u(n_pillars, pillar_points)
    pillars = torch.stack([c[:, :1] + r * torch.cos(th),
                           c[:, 1:] + r * torch.sin(th),
                           u(n_pillars, pillar_points) * h], -1)
    o = (u(n_walls, 2) * 2.0 - 1.0) * extent
    ang = math.pi * u(n_walls, 1)
    length = 8.0 + 17.0 * u(n_walls, 1)
    s = u(n_walls, wall_points) * length
    walls = torch.stack([o[:, :1] + s * torch.cos(ang),
                         o[:, 1:] + s * torch.sin(ang),
                         3.0 * u(n_walls, wall_points)], -1)
    return torch.cat([ground, pillars.reshape(-1, 3),
                      walls.reshape(-1, 3)]).to(torch.float32)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz unit quaternions -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def scans(world: torch.Tensor, poses: torch.Tensor, gen: torch.Generator,
          raw_points: int, noise: float, max_range: float = 35.0,
          min_range: float = 0.5, chunk: int = 16):
    """Scans at (F, 7) poses [t, q wxyz] -> points (F, raw_points, 3)
    float32 in the sensor frame (PAD on unused lanes) and their mask."""
    dev = world.device
    n = poses.shape[0]
    k = min(raw_points, world.shape[0])
    pts = torch.full((n, raw_points, 3), PAD, dtype=torch.float32,
                     device=dev)
    mask = torch.zeros((n, raw_points), dtype=torch.bool, device=dev)
    for a in range(0, n, chunk):
        p = poses[a:a + chunk].to(dev, torch.float32)
        d = world[None] - p[:, None, :3]
        dist = torch.linalg.vector_norm(d, dim=-1)
        keep = (dist < max_range) & (dist > min_range)
        # a random subset of the points in range: the k smallest of
        # uniform keys, out-of-range points keyed past every real one
        key = torch.rand(dist.shape, generator=gen, device=dev)
        key = torch.where(keep, key, torch.full_like(key, 2.0))
        kv, idx = torch.topk(key, k, dim=1, largest=False, sorted=False)
        local = torch.gather(d, 1, idx[..., None].expand(-1, -1, 3))
        local = local @ quat_to_mat(p[:, 3:7])  # R^T applied to each point
        local = local + noise * torch.randn(local.shape, generator=gen,
                                            device=dev)
        ok = kv < 2.0
        pts[a:a + chunk, :k] = torch.where(ok[..., None], local,
                                           torch.full_like(local, PAD))
        mask[a:a + chunk, :k] = ok
    return pts, mask
