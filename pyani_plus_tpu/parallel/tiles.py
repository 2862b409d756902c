"""Device-mesh pair-tile sharding: the N x N comparison grid on the cards.

The replacement for the reference's column sharding over
Snakemake jobs (SURVEY.md section 2.4): the all-vs-all grid is tiled
over a ``jax.sharding.Mesh`` with a 2D ("q", "s") layout -- query
genomes sharded along "q", subject genomes along "s" -- so each device
owns an (N/q x N/s) tile of the pair grid. Sketch membership blocks are
laid out so the contraction (hash) axis streams in full while the
genome axes ride the mesh; XLA inserts the collectives (NCCL over
NVLink on GPUs) from the shardings. The cards of one host reach each
other all to all, so the mesh shape follows the algorithm alone.

These entry points are also what ``__graft_entry__.dryrun_multichip``
compiles on a virtual device mesh to validate the multi-chip path.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def make_mesh(n_devices: int | None = None, *, axis_names=("q", "s")):
    """Build a 2D mesh over the available devices (q-major factorisation)."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    # Factor n into (nq, ns) as square as possible
    nq = int(np.floor(np.sqrt(n)))
    while n % nq:
        nq -= 1
    ns = n // nq
    dev_array = np.array(devices).reshape(nq, ns)
    return Mesh(dev_array, axis_names)


_DEFAULT_MESH_CACHE: dict[tuple, object] = {}


def default_pair_mesh():
    """The production pair-grid mesh: all local devices, or None for one.

    Every multi-device host automatically shards the pair-grid kernels
    (sourmash containment Gram, batched DP dispatch) over this mesh --
    the analogue of the reference's local executor using all
    cores (workflows/__init__.py:158-171). ``PYANI_TPU_MESH=0`` forces
    single-device execution.
    """
    import os

    import jax

    if os.environ.get("PYANI_TPU_MESH", "1") == "0":
        return None
    devices = jax.devices()
    if len(devices) < 2:
        return None
    key = tuple(getattr(d, "id", i) for i, d in enumerate(devices))
    mesh = _DEFAULT_MESH_CACHE.get(key)
    if mesh is None:
        mesh = make_mesh()
        _DEFAULT_MESH_CACHE[key] = mesh
    return mesh


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int) -> np.ndarray:
    """Zero-pad an axis up to a multiple (static-shape friendliness)."""
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(array, pad)


def sharded_intersection_counts(membership: np.ndarray, mesh) -> np.ndarray:
    """All-pairs sketch-intersection counts on a device mesh.

    ``membership`` is the (N, U) {0,1} sketch membership matrix (int8).
    Rows are sharded along "q" for the left operand and along "s" for
    the right operand; each device computes its local (Nq x Ns)
    Gram tile -- no all-gather of the full matrix is ever materialised,
    only the two row-block layouts. Returns the (N, N) counts.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = membership.shape[0]
    nq, ns = mesh.devices.shape
    lcm = np.lcm(nq, ns)
    padded = pad_to_multiple(membership, lcm, 0)

    x = jax.device_put(
        jnp.asarray(padded), NamedSharding(mesh, P("q", None))
    )
    y = jax.device_put(
        jnp.asarray(padded), NamedSharding(mesh, P("s", None))
    )

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P("q", "s")))
    def gram(a, b):
        return jnp.dot(
            a.astype(jnp.float32),
            b.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
        )

    counts = gram(x, y)
    return np.asarray(counts)[:n, :n].astype(np.int64)


def sharded_containment_step(mesh):
    """Return a jitted sharded step: membership blocks -> counts tile.

    The returned function is the "training step" analogue used by the
    multichip dry run: it takes q-sharded and s-sharded membership
    blocks plus a running counts tile and returns the updated counts
    (streaming over hash blocks).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    @partial(
        jax.jit,
        out_shardings=NamedSharding(mesh, P("q", "s")),
    )
    def step(counts, q_block, s_block):
        return counts + jnp.dot(
            q_block.astype(jnp.float32),
            s_block.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
        )

    return step


def merge_partial_matrices(blocks: np.ndarray, mesh) -> np.ndarray:
    """Collectively merge per-device partial result matrices (psum).

    ``blocks`` is (n_devices, N, N): device d's zero-masked partial of
    the full result matrix (its owned pair tiles filled, the rest 0).
    A ``shard_map`` psum over the whole mesh reduces them into the
    replicated full matrix -- the on-device analogue of the reference's
    JSON-import merge loop (workflows/__init__.py:49-109), which the
    multichip dry run exercises alongside the Gram step.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map

    axes = mesh.axis_names

    def body(x):
        return jax.lax.psum(x[0], axis_name=axes)

    merged = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=P(axes, None, None),
            out_specs=P(None, None),
        )
    )(
        jax.device_put(
            jnp.asarray(blocks), NamedSharding(mesh, P(axes, None, None))
        )
    )
    return np.asarray(merged)


def owned_pairs(n: int, process_index: int, process_count: int) -> list[tuple[int, int]]:
    """Static block ownership of the pair grid for multi-host runs.

    Host h owns every (q, s) pair with (q * n + s) % process_count == h;
    content-addressed INSERT OR IGNORE merges make overlapping ownership
    harmless (same discipline as the reference's workers).
    """
    return [
        (q, s)
        for q in range(n)
        for s in range(n)
        if (q * n + s) % process_count == process_index
    ]
