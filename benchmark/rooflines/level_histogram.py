"""Bytes that one real step's level_histogram launches need, worked out
from the config and the cell's epoch; a graph replay shows no shapes.

A real step differentiates the encodes of its sites. Of a stream of S
samples (sample_budget a ray, or every one of the max_samples_per_ray
slots without a budget): the samples with the perturbed-smoothness sites
(smooth_budget a ray, or one a sample without a budget) when
merge_smooth, else the two apart; the surface band's sites (the SDF table
alone): under band_reuse with a band_budget one encode of band_budget a
ray, else the ladder's two normals (n1 and n2), each an encode of
band_budget a ray or, without a budget, of every rung (trunc*100+1 a ray);
with surf_sdf_weight, one surface point a ray. A budget that holds the
whole set keeps it whole. C is 4 with the colour table (the SDF's 2 and
the colour's 2), else 2. Under hist_rows each encode launches the kernel
twice:

- the packed dense prefix, the first levels whose whole lattice fits
  their table: one index a site and level, and one payload row of the
  2^3 corners' C f32 cotangents side by side, into a table of those
  levels' rows at that width (2^3 * C);
- the other launched levels: one index a site, corner and level, and one
  payload row of C f32, into the (rows, C) table, of which the kernel
  writes the launched levels' rows.

Other routes launch the second form for every launched level. The
launched levels are the active ones rounded up to an even count, as the
port's step graph keys them (its mask zero-fills the extra level). Counted
once each: the int32 indices and the f32 payload read (a bf16 payload is
rounded from f32 as the kernel loads it), and the launched levels' rows
written in f32."""
from __future__ import annotations

CORNERS = 8
F32, I32 = 4, 4


def active_levels(cfg: dict, epoch: int) -> int:
    from benchmark.reference.hashgrid import active_count
    from benchmark.reference.schedule import Curriculum
    L = int(cfg["model"].get("grid_num_levels", 16))
    curr = Curriculum.from_config(cfg)
    if not curr.progressive_level:
        return L
    return active_count(curr.max_level(epoch), L)


def launched_levels(cfg: dict, epoch: int) -> int:
    """The active levels rounded up to an even count, at most all."""
    a = active_levels(cfg, epoch)
    return min(int(cfg["model"].get("grid_num_levels", 16)), a + (a & 1))


def _within(budget: int, whole: int) -> int:
    """The sites a budget keeps of `whole` (all without a budget)."""
    return min(budget, whole) if budget else whole


def encodes(cfg: dict) -> list:
    """(sites, channels) of each differentiated encode of a real step."""
    tr, tpu = cfg["train"], cfg["tpu"]
    N = int(tr["real_ray_num"])
    C = 4 if cfg["model"]["color_grid"] else 2
    samples = _within(int(tpu["sample_budget"]) * N,
                      int(tpu["max_samples_per_ray"]) * N)
    smooth = _within(int(tpu["smooth_budget"]) * N, samples)
    out = ([(samples + smooth, C)] if tpu.get("merge_smooth", True)
           else [(samples, C), (smooth, C)])
    band = int(tpu["band_budget"]) * N
    if tpu.get("band_reuse", True) and band:
        out.append((_within(band, samples), 2))
    else:
        rungs = int(tr["trunc"] * 100 + 1) * N
        out += [(_within(band, rungs), 2)] * 2
    if tr["surf_sdf_weight"] > 0:
        out.append((N, C))
    return out


def _grid(cfg: dict):
    from benchmark.reference.step import field_spec
    return field_spec(cfg, 1, 1.0).grid


def packed_levels(cfg: dict, levels: int) -> int:
    """Levels of the packed dense prefix among the first `levels`: under
    hist_rows, those from the first whose lattice fits their table."""
    if cfg["tpu"]["vjp_mode"] != "hist_rows":
        return 0
    g = _grid(cfg)
    k = 0
    while (k < levels and g.resolutions[k] ** g.input_dim
           <= g.offsets[k + 1] - g.offsets[k]):
        k += 1
    return k


def launches(cfg: dict, cell: dict) -> list:
    """Each launch of one real step: {"idx": (levels, n) int32, "vals":
    (levels * n, width) f32, "starts": each level's first row, "n_rows":
    the output table's rows, "written": the rows the launch writes}."""
    L = launched_levels(cfg, cell["epoch"])
    k = packed_levels(cfg, L)
    offs = _grid(cfg).offsets
    out = []
    for S, C in encodes(cfg):
        if k:
            out.append({"idx": (k, S), "vals": (k * S, CORNERS * C),
                        "starts": tuple(offs[:k]), "n_rows": offs[k],
                        "written": offs[k]})
        if L > k:
            n = CORNERS * S
            out.append({"idx": (L - k, n), "vals": ((L - k) * n, C),
                        "starts": tuple(offs[k:L]), "n_rows": offs[-1],
                        "written": offs[L] - offs[k]})
    return out


def launch_bytes(launch: dict) -> int:
    (levels, n), (rows, width) = launch["idx"], launch["vals"]
    return (levels * n * I32 + rows * width * F32
            + launch["written"] * width * F32)


def real_step_bytes(cfg: dict, cell: dict) -> int:
    return sum(launch_bytes(x) for x in launches(cfg, cell))
