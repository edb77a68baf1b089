"""Several devices of one host driven by one process: the port of
genomics_general_tpu/parallel/mesh.py.

A :class:`Mesh` is a tuple of torch devices along one axis, ``"data"``.
The JAX package places arrays over its ``jax.sharding.Mesh`` with
``NamedSharding``; here the placement is explicit, with JAX's shapes:

* the window batch is sharded data-parallel: padded to ``n_dev * 2^k``,
  one contiguous slab of windows per device, the allele matrix
  replicated (the ``mesh=`` dispatches of the pair counts and of
  kernels/abba.py), or each slab sent the wire of only the sites its
  windows cover (pairdist's blocks dispatches, ``pairdist.upload_slabs``);
* the site axis is sharded sequence-parallel: padded with missing sites
  to a multiple of the mesh size, one contiguous slab of sites per device
  (``counts.site_pop_counts_dispatch(mesh=)``, :func:`sharded_global_sfs`);
* the haplotype rows of the [W, H, H] counts are sharded tensor-parallel:
  padded with missing rows to ``Hp``, one block of rows per device (K14);
* genome-wide accumulators are merged by copying every shard to the
  mesh's first device and reducing there (K16, :func:`reduce_on_first`),
  the counterpart of ``psum``.

Results come back to the host in window or site order.  A mesh may name a
device more than once (``Mesh([cpu] * 8)`` in the CPU tests, two shards on
one card in chip_smoke.py): each entry is a shard of its own.  Every
shard's launches run with its device current (transfer.fetch_on).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_scope, get_device
from ..kernels import counts as counts_k
from ..kernels import pairdist as pair_k
from ..kernels import transfer


class Mesh:
    """A one-axis (``"data"``) mesh of torch devices."""

    axis_names = ("data",)

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The first ``n_devices`` CUDA devices (default: all of them); under
    ``GGT_DEVICE=cpu``, ``n_devices`` copies of the CPU device (default
    one).  Asking for more cards than exist raises."""
    if get_device().type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def reduce_on_first(shards, mesh: Mesh, op: str = "sum") -> np.ndarray:
    """Sum (or min) [k_d, ...] int32 / int64 tensors, one per shard, over
    their leading axes: each is copied to ``mesh.devices[0]`` (a peer copy
    between cards), they are stacked there and K16 reduces the stack.
    Returns the [...] result on the host."""
    first = mesh.devices[0]
    stacked = torch.cat([s.to(first) for s in shards])
    return transfer.fetch_on(first, lambda: counts_k.stacked_reduce(
        stacked, op)).wait()


def sharded_window_pair_counts(alleles: np.ndarray, first: np.ndarray,
                               n_sites: np.ndarray, mesh: Mesh,
                               s_max: int | None = None):
    """Data-parallel pair counts: the window batch sharded over the mesh,
    the allele matrix replicated, K9 + K4 on each device's slab
    (``pairdist.window_pair_counts(mesh=)``).  Each window reads at most
    ``s_max`` sites (the JAX gather's width; by default all of its own).
    Returns numpy (mismatch [W, H, H], shared [W, H, H])."""
    if s_max is not None:
        n_sites = np.minimum(n_sites, s_max)
    return pair_k.window_pair_counts(alleles, first, n_sites, mesh=mesh)


def sharded_pair_counts_tp(alleles: np.ndarray, first: np.ndarray,
                           n_sites: np.ndarray, mesh: Mesh,
                           s_max: int | None = None):
    """Tensor-parallel pair counts: the haplotype rows of the [W, H, H]
    output, padded with missing rows to a multiple ``Hp`` of the mesh size,
    sharded over its devices, the allele matrix and the windows
    replicated; K14 counts each device's row block against every row.
    Returns numpy (mismatch [W, H, H], shared [W, H, H])."""
    n_dev = mesh.size
    W = first.shape[0]
    H = alleles.shape[0]
    if s_max is None:
        s_max = max(256, int((int(n_sites.max()) if W else 1) + 255)
                    // 256 * 256)
    Hp = -(-H // n_dev) * n_dev
    a = np.full((Hp, alleles.shape[1]), -1, dtype=np.int8)
    a[:H] = alleles
    win = np.stack([np.ascontiguousarray(first, np.int32),
                    np.minimum(n_sites, s_max).astype(np.int32)])
    longest = int(win[1].max()) if W else 0
    parts = []
    for d, al, wn, (r0, r1) in zip(
            mesh.devices, transfer.replicate(a, mesh).shards,
            transfer.replicate(win, mesh).shards,
            transfer.sharded_axis(Hp, n_dev)):
        parts.append(transfer.fetch_on(d, lambda: torch.stack(
            pair_k.pair_counts_4state_rows(al, wn[0], wn[1], r0, r1,
                                           longest))))
    out = np.concatenate([p.wait() for p in parts], axis=2)
    return out[0, :, :H, :H], out[1, :, :H, :H]


def sharded_site_pop_counts(alleles: np.ndarray, pop_mask: np.ndarray,
                            mesh: Mesh) -> np.ndarray:
    """Sequence-parallel allele counting: the site axis sharded over the
    mesh (``counts.site_pop_counts_chunked(mesh=)``).  Returns int32
    [S, P, 4]."""
    return counts_k.site_pop_counts_chunked(alleles, pop_mask, mesh=mesh)


def sharded_global_sfs(alleles: np.ndarray, pop_mask: np.ndarray,
                       n_hap: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Genome-wide folded joint SFS: each device counts its slab of the
    sharded site axis (K12) and bins its complete sites (K15), and the
    per-device spectra are summed on the mesh's first device (K16).
    Returns a dense int32 [n_hap[0] + 1, ..., n_hap[P - 1] + 1] spectrum
    counting sites with complete data in every population (the
    second-commonest allele as target)."""
    H, S = alleles.shape
    Sp = -(-S // mesh.size) * mesh.size
    a = np.full((H, Sp), -1, dtype=np.int8)
    a[:, :S] = alleles
    hists = []
    for d, (lo, hi) in zip(mesh.devices,
                           transfer.sharded_axis(Sp, mesh.size)):
        slab = transfer.to_device(a[:, lo:hi], d)
        with device_scope(d):
            groups, classes = counts_k._count_groups(pop_mask, d)
            c = counts_k.count_raw(slab, hi - lo, groups)          # K12
            if classes is not None:        # the mask rows' sums of classes
                bits = torch.from_numpy(classes.bits).to(d)        # [C, P]
                c = (c.to(torch.int64)[:, :, None, :]
                     * bits[None, :, :, None]).sum(dim=1).to(torch.int32)
            hists.append(counts_k.global_sfs_hist(c, n_hap)[None])
    return reduce_on_first(hists, mesh).reshape(counts_k.sfs_dims(n_hap))
