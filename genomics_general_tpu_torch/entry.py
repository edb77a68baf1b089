"""The port's counterparts of ``__graft_entry__``.

``entry()`` returns ``(fn, example_args)``: the fused window-statistics
step (K9 pair counts, K10 pi / dxy / Fst, K11 allele counts) and the same
example data as the JAX entry (``np.random.default_rng(0)``), on
``get_device()`` (the card unless ``GGT_DEVICE=cpu``).
``dryrun_multichip(n)`` runs the sharded routes once over an n-device
mesh (parallel/mesh.py) on small shapes and holds each against its
meshless route.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import get_device
from .kernels.window_stats import window_stats_step


def _example_data(n_sites=4096, n_ind=8, seed=0):
    rng = np.random.default_rng(seed)
    H = n_ind * 2
    alleles = rng.integers(0, 4, size=(H, n_sites)).astype(np.int8)
    alleles[rng.random((H, n_sites)) < 0.05] = -1
    pop_mask = np.zeros((2, H), dtype=np.float32)
    pop_mask[0, :H // 2] = 1
    pop_mask[1, H // 2:] = 1
    n_windows = 8
    first = np.arange(0, n_sites, n_sites // n_windows,
                      dtype=np.int32)[:n_windows]
    n_s = np.full(n_windows, n_sites // n_windows, dtype=np.int32)
    return alleles, first, n_s, pop_mask


def entry():
    """Return (fn, example_args): the forward step and its example
    tensors on the device."""
    dev = get_device()
    example_args = tuple(torch.from_numpy(x).to(dev)
                         for x in _example_data())
    return window_stats_step, example_args


def _same_text(a: str, b: str, what: str) -> None:
    with open(a) as fa, open(b) as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: mesh output != meshless output")


def dryrun_multichip(n_devices: int) -> None:
    """One full sharded step over an ``n_devices`` mesh (small shapes),
    the JAX ``dryrun_multichip``:

    * data parallel: the window batch over the mesh (K9), and tensor
      parallel: the [W, H, H] rows over the mesh (K14), both equal to the
      meshless pair counts;
    * sequence parallel: the site axis over the mesh (K12), and the
      genome-wide SFS merged over the mesh (K15, K16);
    * popgenWindows (popFreq popDist popPairDist) and ABBABABAwindows on
      the mesh, byte-equal to their meshless runs (``GGT_NO_MESH=1``);
    * the sfs and distMat cat merges: per-"host" partials (scaffolds
      split over the devices) stacked over the mesh and merged by
      ``multihost.mesh_reduce_stacked``, equal to the meshless CLIs'
      output text.

    The CLIs see the mesh through ``cli.common.get_mesh``, patched for
    the mesh runs.  Raises AssertionError on any difference."""
    import os
    import tempfile
    from unittest import mock

    from .cli import common
    from .cli.abba_windows import main as abba_main
    from .cli.dist_mat import main as dm_main
    from .cli.popgen_windows import main as popgen_main
    from .cli.sfs import main as sfs_main
    from .io import geno as geno_io
    from .io.writers import dist_mat_phylip_string
    from .kernels import counts as counts_k
    from .kernels import pairdist as pair_k
    from .parallel import mesh as pmesh
    from .parallel import multihost
    from .samples import SampleData
    from .stats import popgen
    from .stats.sfs_accum import DenseFS, ScaffoldKeyTracker, vector_targets
    from .testing import write_geno, write_pops_file

    m = pmesh.make_mesh(n_devices)
    alleles, first, n_s, pop_mask = _example_data(n_sites=2048, n_ind=6)

    # data-parallel and tensor-parallel pair counts against the meshless
    mism, shar = pmesh.sharded_window_pair_counts(alleles, first, n_s, m,
                                                  s_max=512)
    m1, s1 = pair_k.window_pair_counts(alleles, first, n_s)
    np.testing.assert_array_equal(mism, m1)
    np.testing.assert_array_equal(shar, s1)
    m_tp, s_tp = pmesh.sharded_pair_counts_tp(alleles, first, n_s, m,
                                              s_max=512)
    np.testing.assert_array_equal(m_tp, m1)
    np.testing.assert_array_equal(s_tp, s1)

    # sequence-parallel allele counting and the merged genome-wide SFS
    counts = pmesh.sharded_site_pop_counts(alleles, pop_mask, m)
    np.testing.assert_array_equal(
        counts, counts_k.site_pop_counts_chunked(alleles, pop_mask))
    n_hap = pop_mask.sum(axis=1).astype(int)
    sfs = pmesh.sharded_global_sfs(alleles, pop_mask, n_hap, m)
    if sfs.shape != tuple(n + 1 for n in n_hap):
        raise AssertionError(f"global SFS of shape {sfs.shape}")

    # the real CLI configs end to end over the mesh, equal to the meshless
    # runs; both on the kernels (GGT_EXEC=tpu, as the JAX dry run pins)
    env = {"GGT_EXEC": "tpu"}
    with tempfile.TemporaryDirectory() as td, \
            mock.patch.dict(os.environ, env):
        geno = os.path.join(td, "dry.geno.gz")
        pops = os.path.join(td, "dry.pops.txt")
        inds = write_geno(geno, n_sites=6000, scaffold_len=200_000,
                          n_scaffolds=2)
        write_pops_file(pops, inds)
        common_args = ["-g", geno, "-f", "phased", "-w", "20000", "-m",
                       "10", "--popsFile", pops, "--writeFailedWindows"]
        runs = {
            "popgen": (popgen_main, ["-p", "pop1", "-p", "pop2",
                                     "--analysis", "popFreq", "popDist",
                                     "popPairDist"]),
            "abba": (abba_main, ["--minData", "0.3", "-P1", "pop1", "-P2",
                                 "pop2", "-P3", "pop3", "-O", "pop4"]),
        }
        for name, (main, extra) in runs.items():
            mesh_out = os.path.join(td, f"{name}_mesh.csv")
            plain_out = os.path.join(td, f"{name}_plain.csv")
            with mock.patch.object(common, "get_mesh", lambda: m):
                main(common_args + extra + ["-o", mesh_out])
            with mock.patch.dict(os.environ, {"GGT_NO_MESH": "1"}):
                main(common_args + extra + ["-o", plain_out])
            _same_text(mesh_out, plain_out, f"{name} CLI")

        # sfs psum merge: per-"host" DenseFS partials (the scaffolds split
        # over the devices, the multi-host sharding) stacked over the mesh
        # and merged (sum counts, min first-occurrence keys) must give the
        # meshless sfs CLI's text
        sfs_main(["-i", geno, "--inputType", "genotypes", "-p", "pop1",
                  "-p", "pop2", "--popsFile", pops,
                  "--pref", os.path.join(td, "ref_"), "--suff", ".sfs"])
        sd = SampleData.from_pop_args(
            population_args=[["pop1"], ["pop2"]], pops_file=pops,
            geno_format="phased")
        reader = geno_io.GenoReader(geno, sample_data=sd,
                                    geno_format="phased")
        data = reader.read_all()
        model = reader.model
        mask = np.zeros((2, model.n_rows), dtype=np.float32)
        for k, p in enumerate(("pop1", "pop2")):
            mask[k, model.pop_row_indices[p]] = 1.0
        nh = [int(mask[k].sum()) for k in range(2)]
        cnts = counts_k.site_pop_counts_chunked(data.alleles, mask)
        keys = ScaffoldKeyTracker().keys_for(data.scaffold_ids)
        partials = []
        for d in range(n_devices):
            own = (data.scaffold_ids % n_devices) == d
            acc = [DenseFS((nh[k] + 1,)) for k in range(2)]
            c = cnts[own]
            complete = (c.sum(axis=2) == np.array(nh)[None, :]).all(axis=1)
            ok, tgt = vector_targets(c[complete].astype(np.int64), None)
            kk = keys[own][complete][ok]
            for k in range(2):
                acc[k].add_batch(acc[k].flat_index(tgt[ok][:, k:k + 1]), kk)
            partials.append(acc)
        for k, pop in enumerate(("pop1", "pop2")):
            merged = DenseFS((nh[k] + 1,))
            merged.merge_from(
                multihost.mesh_reduce_stacked(
                    np.stack([q[k].counts for q in partials]), m, "sum"),
                multihost.mesh_reduce_stacked(
                    np.stack([q[k].first for q in partials]), m, "min"))
            with open(os.path.join(td, f"ref_{pop}.sfs")) as f:
                if merged.as_text() != f.read():
                    raise AssertionError(f"mesh-merged sfs != meshless sfs "
                                         f"({pop})")

        # distMat cat merge: per-"host" [H, H] pair-count accumulators,
        # packed as the CLI packs them and merged over the mesh, must
        # finalize to the meshless distMat cat output
        dm_out = os.path.join(td, "dm_cat.phy")
        dm_main(["-g", geno, "-f", "phased", "--windType", "cat",
                 "--outFormat", "phylip", "-o", dm_out])
        full_sd = SampleData(ind_names=list(inds),
                             ploidy={n: 2 for n in inds})
        full_reader = geno_io.GenoReader(geno, sample_data=full_sd,
                                         geno_format="phased")
        full = full_reader.read_all()
        fmodel = full_reader.model
        H = fmodel.n_rows
        packs = []
        for d in range(n_devices):
            own = (full.scaffold_ids % n_devices) == d
            acc = pair_k.CatPairAccumulator(H)
            acc.add(np.ascontiguousarray(full.alleles[:, own]))
            m0, s0 = acc.finish()
            called = (full.alleles[:, own] >= 0).sum(axis=1).astype(np.int64)
            packs.append(np.concatenate(
                [m0.ravel(), s0.ravel(), called,
                 [np.int64(int(own.sum()))]]))
        merged = multihost.mesh_reduce_stacked(np.stack(packs), m, "sum")
        ctx = popgen.DistStatsContext(merged[:H * H].reshape(H, H)[None],
                                      merged[H * H:2 * H * H]
                                      .reshape(H, H)[None])
        pd = popgen.ind_pair_dists(ctx, fmodel.sample_names,
                                   fmodel.sample_rows)
        n_ind = len(inds)
        dist_out = np.full((n_ind, n_ind), np.nan)
        for i in range(n_ind):
            for j in range(i, n_ind):
                dist_out[i, j] = dist_out[j, i] = pd[inds[i]][inds[j]][0]
        with open(dm_out) as f:
            if dist_mat_phylip_string(dist_out, inds, 4) != f.read():
                raise AssertionError("mesh-merged distMat cat != meshless "
                                     "output")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", {k: tuple(v.shape) for k, v in out.items()})
    # every card, at most 8 (the JAX entry's bound); 8 CPU entries
    dryrun_multichip(min(8, torch.cuda.device_count())
                     if get_device().type == "cuda" else 8)
    print("dryrun_multichip ok")
