"""Synthetic scan-sequence generators for tests and benchmarks.

The reference ships no datasets or fixtures (SURVEY.md §4); these
generators implement the five BASELINE.json benchmark configs: a single
ICP pair, a corridor odometry run, a loop trajectory, and Velodyne-scale
scans with structured geometry (so point-to-plane has meaningful normals).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _se3(x=0.0, y=0.0, z=0.0, yaw=0.0) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[:3, 3] = [x, y, z]
    return T


def corridor_world(rng, n_points: int = 20000, length: float = 60.0,
                   width: float = 4.0, height: float = 3.0) -> np.ndarray:
    """A corridor: two walls, floor and ceiling, with wall-mounted boxes
    for longitudinal texture (pure planes make x unobservable for ICP)."""
    counts = np.floor(n_points * np.array([0.3, 0.3, 0.2, 0.2])).astype(int)
    pts = []
    x = rng.uniform(0, length, counts[0])
    pts.append(np.stack([x, np.full_like(x, -width / 2),
                         rng.uniform(0, height, counts[0])], -1))
    x = rng.uniform(0, length, counts[1])
    pts.append(np.stack([x, np.full_like(x, width / 2),
                         rng.uniform(0, height, counts[1])], -1))
    x = rng.uniform(0, length, counts[2])
    pts.append(np.stack([x, rng.uniform(-width / 2, width / 2, counts[2]),
                         np.zeros(counts[2])], -1))
    x = rng.uniform(0, length, counts[3])
    pts.append(np.stack([x, rng.uniform(-width / 2, width / 2, counts[3]),
                         np.full(counts[3], height)], -1))
    world = np.concatenate(pts, 0)
    # Boxes every 5 m alternating sides.
    n_box = max(1, n_points // 20)
    for i, bx in enumerate(np.arange(2.5, length, 5.0)):
        side = -1 if i % 2 == 0 else 1
        c = np.array([bx, side * (width / 2 - 0.4), 0.6])
        box = rng.uniform(-0.4, 0.4, (n_box, 3)) + c
        world = np.concatenate([world, box], 0)
    return world.astype(np.float32)


def render_scan(world: np.ndarray, T_world_sensor: np.ndarray, rng,
                n_points: int = 1000, max_range: float = 15.0,
                noise: float = 0.0) -> np.ndarray:
    """Sample a scan: world points within range, expressed in sensor frame."""
    rel = world - T_world_sensor[:3, 3]
    d = np.linalg.norm(rel, axis=-1)
    visible = np.nonzero(d <= max_range)[0]
    if len(visible) == 0:
        raise ValueError("no world points in range")
    take = rng.choice(visible, size=min(n_points, len(visible)),
                      replace=len(visible) < n_points)
    R = T_world_sensor[:3, :3]
    local = (world[take] - T_world_sensor[:3, 3]) @ R
    if noise:
        local = local + rng.normal(size=local.shape) * noise
    return local.astype(np.float32)


def corridor_sequence(rng, n_scans: int = 200, scan_points: int = 1000,
                      step: float = 0.25, noise: float = 0.005,
                      odom_noise: float = 0.01,
                      length: float = 60.0
                      ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                 List[np.ndarray]]:
    """BASELINE config 2: straight corridor run.

    Returns (scans, odometry T_world_robot w/ drift, ground-truth poses).
    """
    world = corridor_world(rng, length=length)
    scans, odom, truth = [], [], []
    T_odom = _se3(1.0, 0.0, 1.2)
    for i in range(n_scans):
        T_true = _se3(1.0 + i * step, 0.0, 1.2)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 noise=noise))
        if i > 0:
            d = np.array([step, 0, 0]) + rng.normal(size=3) * odom_noise
            T_odom = T_odom @ _se3(*d)
        truth.append(T_true)
        odom.append(T_odom.copy())
    return scans, odom, truth


def loop_world(rng, n_points: int = 40000, radius: float = 12.0,
               width: float = 4.0, height: float = 3.0) -> np.ndarray:
    """An annular corridor (ring) with boxes for angular texture."""
    n_wall = n_points // 4
    pts = []
    for r in (radius - width / 2, radius + width / 2):
        a = rng.uniform(0, 2 * np.pi, n_wall)
        pts.append(np.stack([r * np.cos(a), r * np.sin(a),
                             rng.uniform(0, height, n_wall)], -1))
    # Floor AND ceiling: with only a floor, map-edge attraction pulls the
    # z estimate systematically downward (nothing pulls back up).
    for z in (0.0, height):
        a = rng.uniform(0, 2 * np.pi, n_wall)
        rr = rng.uniform(radius - width / 2, radius + width / 2, n_wall)
        pts.append(np.stack([rr * np.cos(a), rr * np.sin(a),
                             np.full(n_wall, z)], -1))
    world = np.concatenate(pts, 0)
    # Dense angular texture: randomly placed/sized boxes and pillars.
    # Placement MUST be aperiodic — any regular angular spacing makes the
    # ring invariant under rotation by the period and scan-to-map ICP
    # aliases onto the symmetry, slipping by whole periods.
    n_box = max(1, n_points // 25)
    n_structures = max(8, int(2 * np.pi * radius / 1.0))
    for _ in range(n_structures):
        ang = rng.uniform(0, 2 * np.pi)
        side = 1 if rng.uniform() < 0.5 else -1
        inset = rng.uniform(0.3, 0.9)
        rp = radius + side * (width / 2 - inset)
        if rng.uniform() < 0.5:
            # box with random half-extents
            half = rng.uniform(0.15, 0.5, 3)
            c = np.array([rp * np.cos(ang), rp * np.sin(ang),
                          rng.uniform(0.2, height - 0.5)])
            box = rng.uniform(-1, 1, (n_box, 3)) * half + c
            world = np.concatenate([world, box], 0)
        else:
            # full-height pillar with random radius
            pr = rng.uniform(0.08, 0.3)
            c = np.array([rp * np.cos(ang), rp * np.sin(ang)])
            theta = rng.uniform(0, 2 * np.pi, n_box)
            pillar = np.stack([pr * np.cos(theta) + c[0],
                               pr * np.sin(theta) + c[1],
                               rng.uniform(0, height, n_box)], -1)
            world = np.concatenate([world, pillar], 0)
    return world.astype(np.float32)


def clover_sequence(rng, n_scans: int = 300, scan_points: int = 512,
                    petals: int = 3, radius: float = 8.0,
                    noise: float = 0.002, odom_drift: float = 0.002,
                    max_range: float = 7.0
                    ) -> Tuple[List[np.ndarray], List[np.ndarray],
                               List[np.ndarray]]:
    """Clover trajectory: ``petals`` tangent ring corridors sharing one
    center point; the robot drives each petal in turn and returns to the
    center between petals. Unlike a multi-lap ring (where relocalization
    against lap-1 keyframes means only the single wrap point ever closes
    a loop), EVERY petal return is a distinct far-in-topology revisit —
    the long golden-replay fixture uses this to pin multiple accepted
    closures, composition swaps, and post-optimization re-anchors in one
    deterministic sequence."""
    worlds = []
    for i in range(petals):
        phi = 2 * np.pi * i / petals
        w = loop_world(rng, n_points=30000, radius=radius)
        c = radius * np.array([np.cos(phi), np.sin(phi), 0.0])
        worlds.append(w + c)
    world = np.concatenate(worlds, 0)
    per = n_scans // petals
    scans, odom, truth = [], [], []
    T_odom = None
    prev_true = None
    for i in range(n_scans):
        petal = min(i // per, petals - 1)
        theta = 2 * np.pi * (i - petal * per) / per
        phi = 2 * np.pi * petal / petals
        c = radius * np.array([np.cos(phi), np.sin(phi)])
        ang = phi + np.pi + theta
        pos = c + radius * np.array([np.cos(ang), np.sin(ang)])
        T_true = _se3(pos[0], pos[1], 1.2, yaw=ang + np.pi / 2)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 max_range=max_range, noise=noise))
        if T_odom is None:
            T_odom = T_true.copy()
        else:
            dT = np.linalg.inv(prev_true) @ T_true
            drift = _se3(odom_drift * rng.normal(),
                         odom_drift * rng.normal(), 0.0,
                         yaw=odom_drift * rng.normal())
            T_odom = T_odom @ dT @ drift
        truth.append(T_true)
        odom.append(T_odom.copy())
        prev_true = T_true
    return scans, odom, truth


def loop_sequence(rng, n_scans: int = 120, scan_points: int = 1000,
                  radius: float = 12.0, noise: float = 0.005,
                  odom_drift: float = 0.002,
                  revolutions: float = 1.08, max_range: float = 7.0,
                  world_points: int = 40000
                  ) -> Tuple[List[np.ndarray], List[np.ndarray],
                             List[np.ndarray]]:
    """BASELINE config 3: loop trajectory with odometric drift; the robot
    passes its starting area again at the end (loop-closure opportunity).

    ``max_range`` must be well below the ring diameter or every scan sees
    the whole world and no keyframes ever spawn. ``world_points`` sizes
    the world; a scan wider than the points in range repeats points."""
    world = loop_world(rng, n_points=world_points, radius=radius)
    scans, odom, truth = [], [], []
    T_odom = None
    prev_true = None
    for i in range(n_scans):
        ang = 2 * np.pi * revolutions * i / n_scans
        T_true = _se3(radius * np.cos(ang), radius * np.sin(ang), 1.2,
                      yaw=ang + np.pi / 2)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 max_range=max_range, noise=noise))
        if T_odom is None:
            T_odom = T_true.copy()
        else:
            dT = np.linalg.inv(prev_true) @ T_true
            drift = _se3(odom_drift * rng.normal(),
                         odom_drift * rng.normal(), 0.0,
                         yaw=odom_drift * rng.normal())
            T_odom = T_odom @ dT @ drift
        truth.append(T_true)
        odom.append(T_odom.copy())
        prev_true = T_true
    return scans, odom, truth


def save_kitti_bin(path: str, points: np.ndarray,
                   reflectance: np.ndarray | None = None) -> None:
    """Write an ``[N, 3]`` point array as a KITTI velodyne ``.bin``
    (float32 x,y,z,reflectance records — the inverse of
    :func:`load_kitti_bin`)."""
    pts = np.asarray(points, np.float32)
    if reflectance is None:
        reflectance = np.zeros(len(pts), np.float32)
    rec = np.concatenate([pts, np.asarray(reflectance, np.float32)[:, None]],
                         axis=1)
    rec.astype(np.float32).tofile(path)


def _raycast(origin: np.ndarray, dirs: np.ndarray, boxes,
             max_range: float) -> np.ndarray:
    """Nearest-hit distances of rays against the ground plane (z=0) and a
    list of axis-aligned boxes ``(center, half_extents)`` — real occlusion,
    unlike :func:`velodyne_like_scan`'s probabilistic wall hits."""
    n = len(dirs)
    t = np.full(n, max_range, np.float32)
    dz = dirs[:, 2]
    tg = np.where(dz < -1e-6, -origin[2] / np.minimum(dz, -1e-6), np.inf)
    t = np.minimum(t, tg.astype(np.float32))
    for c, half in boxes:
        bmin, bmax = c - half, c + half
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
            t1 = (bmin - origin) * inv
            t2 = (bmax - origin) * inv
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= np.maximum(tmin, 1e-3)) & (tmin > 1e-3)
        t = np.where(hit, np.minimum(t, tmin.astype(np.float32)), t)
    return t


def harsh_velodyne_pair(rng, n_points: int = 32768, n_rings: int = 64,
                        max_range: float = 60.0,
                        twist: np.ndarray | None = None,
                        dynamic_fraction: float = 0.15,
                        noise: float = 0.01
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A real-world-shaped scan pair: true raycast occlusion, range
    dropout / density falloff, sensor noise, and moving objects between
    the two scans (the failure modes battle-tested LiDAR pipelines must
    shrug off).

    Returns ``(scan_a, scan_b, T_a_b)`` where both scans are in their own
    sensor frames and ``T_a_b`` maps sensor-b coordinates into sensor-a.
    """
    if twist is None:
        twist = np.array([0.4, -0.25, 0.03, 0.01, -0.008, 0.03], np.float32)
    # Static scene: ground plane + walls/boxes of varied scale.
    static = []
    for _ in range(35):
        c = np.array([rng.uniform(-35, 35), rng.uniform(-35, 35),
                      rng.uniform(0.5, 2.5)])
        half = rng.uniform([0.3, 0.3, 0.5], [4.0, 4.0, 2.5])
        static.append((c, half))
    # Dynamic objects (cars/pedestrians): present in both scans but moved.
    dynamic_a, dynamic_b = [], []
    for _ in range(8):
        c = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 0.8])
        half = rng.uniform([0.6, 0.4, 0.4], [2.2, 1.0, 0.9])
        shift = np.array([rng.uniform(-3, 3), rng.uniform(-3, 3), 0.0])
        dynamic_a.append((c, half))
        dynamic_b.append((c + shift, half))

    import jax.numpy as jnp
    from . import se3
    T_a_b = np.asarray(se3.exp(jnp.asarray(twist)), np.float32)

    def spin(origin, R, boxes, frac_dynamic_rays):
        per_ring = n_points // n_rings
        dirs = []
        for ring in range(n_rings):
            elev = np.deg2rad(-24.0 + ring * (26.0 / n_rings))
            az = rng.uniform(0, 2 * np.pi, per_ring)
            ce = np.cos(elev)
            dirs.append(np.stack([ce * np.cos(az), ce * np.sin(az),
                                  np.full(per_ring, np.sin(elev))], -1))
        d_sensor = np.concatenate(dirs, 0).astype(np.float32)
        d_world = d_sensor @ R.T
        t = _raycast(origin, d_world, boxes, max_range)
        # Range-dependent dropout (density falloff) + random misses.
        p_return = np.exp(-t / 45.0) * 0.97
        keep = (t < max_range) & (rng.uniform(0, 1, len(t)) < p_return)
        pts_world = origin + t[:, None] * d_world
        pts = (pts_world - origin) @ R  # sensor frame
        pts = pts[keep]
        if noise:
            pts = pts + rng.normal(size=pts.shape) * noise
        del frac_dynamic_rays
        return pts.astype(np.float32)

    eye = np.eye(3, dtype=np.float32)
    origin_a = np.array([0.0, 0.0, 1.8], np.float32)
    scan_a = spin(origin_a, eye, static + dynamic_a, dynamic_fraction)
    # Scan b: sensor moved by T_a_b (sensor-b origin/axes in world frame).
    R_b = T_a_b[:3, :3].astype(np.float32)
    origin_b = (origin_a + T_a_b[:3, 3]).astype(np.float32)
    scan_b = spin(origin_b, R_b, static + dynamic_b, dynamic_fraction)
    return scan_a, scan_b, T_a_b


def load_kitti_bin(path: str, max_points: int | None = None) -> np.ndarray:
    """Load a KITTI velodyne ``.bin`` scan (float32 x,y,z,reflectance
    records) as an ``[N, 3]`` point array (BASELINE config 4 input
    format)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts = raw[:, :3]
    if max_points is not None and len(pts) > max_points:
        pts = pts[:max_points]
    return np.ascontiguousarray(pts)


def velodyne_like_scan(rng, n_points: int = 65536, n_rings: int = 64,
                       max_range: float = 50.0) -> np.ndarray:
    """BASELINE config 4 source: a synthetic 64-ring spin over a structured
    scene (ground plane + random walls/boxes), ~64k points."""
    world_boxes = []
    for _ in range(40):
        c = np.array([rng.uniform(-30, 30), rng.uniform(-30, 30),
                      rng.uniform(0, 2)])
        size = rng.uniform(0.5, 4.0, 3)
        world_boxes.append((c, size))
    per_ring = n_points // n_rings
    pts = []
    for ring in range(n_rings):
        elev = np.deg2rad(-24.0 + ring * (26.0 / n_rings))
        az = rng.uniform(0, 2 * np.pi, per_ring)
        # Ray-cast against ground plane (z=0 from sensor at z=1.8).
        dz = np.sin(elev)
        rng_ground = np.where(dz < -1e-3, -1.8 / np.minimum(dz, -1e-3),
                              max_range)
        r = np.minimum(rng_ground, max_range)
        # Random wall hits shorten some rays.
        hit = rng.uniform(0, 1, per_ring) < 0.35
        r = np.where(hit, rng.uniform(2, 30, per_ring), r)
        cos_e = np.cos(elev)
        pts.append(np.stack([r * cos_e * np.cos(az), r * cos_e * np.sin(az),
                             1.8 + r * dz], -1))
    out = np.concatenate(pts, 0)[:n_points]
    return out.astype(np.float32)
