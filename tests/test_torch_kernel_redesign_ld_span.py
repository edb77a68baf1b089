"""The redesigned K17 (ld.cu, LD pair tables on the int8 tensor cores) and
K6 (counts.cu, per-site counts of the span wire on the row-slot loop) on
the CPU: numpy models of the kernels' arithmetic — K17's K-major one-hot
scratch, its upper-triangle tile walk and mirrored epilogue; K6's span-wire
decode into K12's 4-codes word and the row-slot loop on it — against the
JAX functions on seeded inputs, exactly.  The kernels themselves run only
on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import counts as jax_counts
from genomics_general_tpu.kernels import ld as jax_ld
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import ld as port_ld
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer
from tests.test_torch_kernel_redesign import LOW, SM, _upper_tiles, decode, \
    messy, sms  # noqa: F401  (sms is a fixture)

CPU = torch.device("cpu")

# ------------------------------------------------------------------ K17

K17_SITES = 32                 # sites a tile side: 128 Gram rows
K17_STEP = 4096                # a tile's 32-haplotype step, bytes
LBO, SBO = 128, 256            # wgmma.cuh's operand layout


def _operand_offset(r, k):
    """Byte of Gram row r (0..127), haplotype k (0..31) in a step's block."""
    return (r // 8) * SBO + (k // 16) * LBO + (r % 8) * 16 + k % 16


def k17_scratch(a: np.ndarray) -> np.ndarray:
    """The one-hot scratch as onehot_kernel writes it: thread (site sl of
    tile R, 16-haplotype chunk hc) decodes its 16 codes (K9's decode) and
    stores plane a, 16 bytes, at Gram row 4 sl + a of step hc / 2, half
    hc % 2; haplotypes past H and sites past S read as missing."""
    H, S = a.shape
    tiles, nsteps = -(-S // K17_SITES), max(-(-H // 32), 1)
    codes = np.full((32 * nsteps, K17_SITES * tiles), -1, np.int8)
    codes[:H, :S] = a
    buf = np.full(tiles * nsteps * K17_STEP, 0xAA, np.uint8)  # unwritten
    for hc in range(2 * nsteps):
        # [16 haplotypes, sites] -> words [sites, 4] of 4 codes each
        words = np.ascontiguousarray(codes[16 * hc:16 * hc + 16].T) \
            .view(np.uint32)
        oh, _ = decode(words)
        for R in range(tiles):
            blk = (R * nsteps + hc // 2) * K17_STEP + (hc % 2) * LBO
            for sl in range(K17_SITES):
                for al in range(4):
                    r = 4 * sl + al
                    o = blk + (r >> 3) * SBO + (r & 7) * 16
                    buf[o:o + 16] = oh[al][K17_SITES * R + sl].view(np.uint8)
    return buf


def k17_operand(buf: np.ndarray, R: int, nsteps: int) -> np.ndarray:
    """Tile R's 128 Gram rows over all steps, read as the wgmma descriptors
    read them: [128, 32 * nsteps] 0/1."""
    r, k = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    off = _operand_offset(r, k)
    steps = [buf[(R * nsteps + q) * K17_STEP + off] for q in range(nsteps)]
    return np.concatenate(steps, axis=1).astype(np.float64)


def k17_model(a: np.ndarray):
    """K17 as the kernels compute it: the scratch, one block per tile of
    the upper triangle (the kernel's walk from blockIdx.x), the tile's
    Gram from the two operands, then the epilogue's stores: the (x, y)
    tables of the tile, and off the diagonal the mirror (y, x) with a and
    b swapped.  Returns the tables and how often each (x, y) was
    written."""
    H, S = a.shape
    tiles, nsteps = -(-S // K17_SITES), max(-(-H // 32), 1)
    buf = k17_scratch(a)
    assert not (buf == 0xAA).any(), "a scratch byte was left unwritten"
    ops = [k17_operand(buf, R, nsteps) for R in range(tiles)]
    out = np.full((S, S, 4, 4), -1, np.int64)
    hits = np.zeros((S, S), np.int64)
    for bx in range(tiles * (tiles + 1) // 2):
        ti, tj = _upper_tiles(bx, tiles)
        g = (ops[ti] @ ops[tj].T).astype(np.int64)        # [128, 128]
        x0, y0 = K17_SITES * ti, K17_SITES * tj
        nx, ny = min(K17_SITES, S - x0), min(K17_SITES, S - y0)
        t = g.reshape(K17_SITES, 4, K17_SITES, 4)[:nx, :, :ny]  # [x,a,y,b]
        out[x0:x0 + nx, y0:y0 + ny] = t.transpose(0, 2, 1, 3)
        hits[x0:x0 + nx, y0:y0 + ny] += 1
        if ti != tj:
            out[y0:y0 + ny, x0:x0 + nx] = t.transpose(2, 0, 3, 1)
            hits[y0:y0 + ny, x0:x0 + nx] += 1
    return out, hits


@pytest.mark.parametrize("S", [1, 31, 32, 33, 97, 597])
@pytest.mark.parametrize("H", [1, 31, 33, 160, 512])
def test_k17_model_and_plain_match_jax(H, S):
    """The scratch layout padded to 32 haplotypes, the upper-triangle walk
    writing every [x, y, a, b] exactly once (mirror included), and the
    plain K17, against JAX ``pair_allele_tables`` with codes -7, -1, 5
    and 127 (none of which counts)."""
    a = messy(H, S, 31 * H + S)
    want = np.asarray(jax_ld.pair_allele_tables(jnp.asarray(a)))
    got, hits = k17_model(a)
    np.testing.assert_array_equal(hits, np.ones((S, S), np.int64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_ld.pair_allele_tables(torch.from_numpy(a)).numpy(), want)


@pytest.mark.parametrize("H, S", [(1, 1), (0, 33), (77, 597), (512, 65)])
def test_k17_scratch_is_what_the_wrapper_allocates(H, S):
    """The wrapper's scratch holds exactly the prologue's blocks (H = 0
    still writes one step of zeros)."""
    want = -(-S // 32) * max(-(-H // 32), 1) * K17_STEP
    assert port_ld.onehot_bytes(H, S) == want
    buf = k17_scratch(messy(H, S, 1))
    assert buf.size == want
    if H == 0:
        assert not buf.any()


# ------------------------------------------------------------------- K6

def span_word(code_byte: np.ndarray, miss_byte: np.ndarray,
              half: np.ndarray) -> np.ndarray:
    """counts.cu SpanRows: code byte b and the miss nibble at bit 4 * half
    of the miss byte -> one uint32 of 4 int8 codes (byte k: site k, -1
    where missing)."""
    b = code_byte.astype(np.uint32)
    m = (miss_byte.astype(np.uint32) >> (4 * half.astype(np.uint32))) & 0xF
    x = (b | b << 6 | b << 12 | b << 18) & np.uint32(0x03030303)
    return x | ((m * np.uint32(0x00204081)) & LOW) * np.uint32(0xFF)


def test_span_word_of_every_code_byte_and_miss_nibble():
    """Every (code byte, miss nibble, nibble half): the decoded word holds
    JAX ``unpack_span``'s codes of the lane's 4 sites (the nibble's shifted
    copies occupy disjoint bits, so nothing carries)."""
    c, m = np.meshgrid(np.arange(256), np.arange(16), indexing="ij")
    c, m = c.ravel().astype(np.uint8), m.ravel().astype(np.uint8)
    n = c.size                                     # 4,096 pairs
    # miss byte j holds pair j in both halves: code bytes 2 j, 2 j + 1
    codes = np.repeat(c, 2)
    miss = (m | (m << 4)).astype(np.uint8)
    sp = 8 * n
    buf = np.concatenate([codes, miss])
    want = np.asarray(jax_transfer.unpack_span(jnp.asarray(buf), sp, 1))[0]
    bidx = np.arange(2 * n)
    words = span_word(codes, miss[bidx >> 1], bidx & 1)
    got = words.view(np.int8).reshape(-1)
    np.testing.assert_array_equal(got, want)


def k6_model(buf: np.ndarray, sp: int, h: int, s0: int, s1: int,
             groups: port_pair.PopGroups, lanes: int) -> np.ndarray:
    """K6 as the kernel counts it: blocks of 4 * lanes sites from s0, a
    lane's word from its code byte and miss nibble (sites at or past s1
    missing), each group's rows dealt over 256 / lanes row slots, 4 rows a
    round (-1 words past the group), the one-hot planes added as packed
    byte lanes and widened once a slot holds more than 251 rows, the slots
    summed."""
    c4, m8 = sp // 4, sp // 8
    codes = buf[:h * c4].reshape(h, c4)
    miss = buf[h * c4:h * (c4 + m8)].reshape(h, m8)
    perm = groups.perm.numpy()
    offs = groups.offs.numpy()
    slots = 256 // lanes
    n = s1 - s0
    nb = -(-n // (4 * lanes))
    c = s0 + 4 * np.arange(nb * lanes)               # every lane's site
    inside = c < s1
    cc = np.where(inside, c, 0)
    words = span_word(codes[:, cc >> 2], miss[:, cc >> 3], (cc >> 2) & 1)
    # sites at or past s1 read as missing
    nv = np.clip(s1 - c, 0, 4)
    pad = np.array([0xFFFFFFFF, 0xFFFFFF00, 0xFFFF0000, 0xFF000000, 0],
                   np.uint32)[nv]
    words = np.where(inside, words | pad, np.uint32(0xFFFFFFFF))
    out = np.zeros((n, groups.P, 4), np.int64)
    for g in range(groups.P):
        rows = perm[offs[g]:offs[g + 1]]
        cnt = np.zeros((4, words.shape[1], 4), np.int64)  # [plane, lane, k]
        for slot in range(slots):
            mine = rows[slot::slots]
            acc = np.zeros((4, words.shape[1]), np.uint32)
            packed = 0
            for r0 in range(0, max(len(mine), 1), 4):
                for r in mine[r0:r0 + 4]:
                    oh, _ = decode(words[r])
                    for a in range(4):
                        acc[a] += oh[a]
                packed += 4
                if r0 + 4 >= len(mine) or packed > 251:
                    assert acc.view(np.uint8).max(initial=0) <= 255
                    cnt += acc.view(np.uint8).reshape(4, -1, 4)
                    acc[:] = 0
                    packed = 0
        out[:, g, :] = cnt.reshape(4, -1)[:, :n].T
    return out


def _span(H, S, seed):
    """messy() codes on the span wire: -7 is missing there too, and the
    wire carries no code above 3 (pack_span's contract)."""
    a = messy(H, S, seed)
    return np.where((a < 0) | (a > 3), -1, a).astype(np.int8)


def _jax_span_counts(a, s0, s1, mask):
    """JAX ``site_pop_counts`` on the span wire's ``_unpack``."""
    buf, sp = jax_transfer.pack_span(a)
    al = jax_transfer.unpack_span(jnp.asarray(buf), sp, a.shape[0])
    return np.asarray(jax_counts.site_pop_counts(al[:, s0:s1],
                                                 jnp.asarray(mask)))


@pytest.mark.parametrize("H, S, s0, s1, lanes", [
    (77, 1003, 0, 1003, 8), (77, 1003, 8, 1003, 16), (33, 517, 24, 517, 8),
    (129, 131, 0, 129, 16), (5, 9, 8, 9, 8), (600, 37, 16, 35, 16)])
def test_k6_model_and_plain_match_jax(H, S, s0, s1, lanes):
    """The span-wire row-slot model and the plain K6 against JAX
    ``site_pop_counts`` on the unpacked span, s0 = 0 and a nonzero
    multiple of 8, s1 not a multiple of 4, on a partition with a 33-row
    group (when H allows)."""
    a = _span(H, S, 11 * H + S)
    rng = np.random.default_rng(H + S)
    cls = rng.integers(0, 4, H)
    cls[:min(33, H)] = 0
    mask = np.zeros((4, H), np.float32)
    mask[cls, np.arange(H)] = 1.0
    want = _jax_span_counts(a, s0, s1, mask)
    buf, sp = port_transfer.pack_span(a)
    groups = port_pair.PopGroups(mask, CPU)
    np.testing.assert_array_equal(
        k6_model(buf, sp, H, s0, s1, groups, lanes), want)
    for dt in (torch.uint16, torch.int32):
        out = torch.empty((s1 - s0, 4, 4), dtype=dt)
        port_counts.site_pop_counts(torch.from_numpy(buf), sp, H, s0, s1,
                                    groups, out)
        np.testing.assert_array_equal(out.numpy().astype(np.int64), want)


def test_k6_model_widens_past_255_rows():
    """One group of 8,300 rows over 32 slots (260 rows each): the byte
    lanes widen before they wrap."""
    a = _span(8300, 13, 6)
    mask = np.ones((1, 8300), np.float32)
    want = _jax_span_counts(a, 8, 13, mask)
    assert -(-8300 // 32) > 255 and want.max() > 255
    buf, sp = port_transfer.pack_span(a)
    groups = port_pair.PopGroups(mask, CPU)
    np.testing.assert_array_equal(k6_model(buf, sp, 8300, 8, 13, groups, 8),
                                  want)


def test_k6_model_on_mask_classes():
    """A mask whose rows overlap and leave rows out (ABBA's, freq's), as
    K6 counts it: on its membership classes, combined, equal to JAX
    ``site_pop_counts`` with the mask itself."""
    H, S = 90, 301
    a = _span(H, S, 12)
    rng = np.random.default_rng(4)
    over = (rng.random((6, H)) < 0.3).astype(np.float32)
    over[5] = 1.0
    over[:, :7] = 0.0
    over[5, :7] = 0.0                                 # rows in no mask
    classes = port_counts.MaskClasses(over, CPU)
    buf, sp = port_transfer.pack_span(a)
    got = classes.combine(k6_model(buf, sp, H, 8, S, classes.groups, 16))
    np.testing.assert_array_equal(got, _jax_span_counts(a, 8, S, over))


def test_k6_lanes_run_a_span(sms):
    """Run A's largest span (32,647 sites, 4 populations): K6 takes 16
    lanes, 2,044 blocks of 64 sites; a one-population block of 4,000
    sites 8 lanes."""
    assert port_counts._k12_lanes(32647, 4, None) == 16
    assert -(-32647 // 64) * 4 >= 4 * SM
    assert port_counts._k12_lanes(4000, 1, None) == 8
