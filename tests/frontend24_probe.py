"""Where the card's 24-view databases split from the CPU's: the front end
of chip_smoke.py's `incremental_24` stage by stage, on the card and on
the CPU from the same inputs, without JAX.

    python tests/frontend24_probe.py [--seeds 0 1 2] [--out DIR]

The 24 views of `incremental_24` (640x480 renderings of
chip_smoke._texture(0) at focal 600). Stage by stage, each held on the
same inputs:

1. SIFT on the card and on the CPU: features per view, the share of the
   card's keypoints within 1e-2 px of a CPU one.
2. Fisher-vector pairs (8 neighbours) from the card's features, the GMM
   trained on the card and on the CPU (each device's generator, seed 0):
   the pairs both choose.
3. Putative matches (no verification) of the card's pairs on the card
   (top2_match) and on the CPU (the brute force): per pair, the matches
   only one side has.
4. Verification per seed: the card's chunk calls (FeatureMatcher's
   verify_matches_batch with the samples the card drew) rerun on the CPU
   with the same samples; per pair, the acceptance, the verified counts
   and the correspondences only one side keeps.
5. INCREMENTAL models (IncrementalOptions(seed), built on the card) from
   four databases: `card` (chip_smoke's path), `cpu_verify` (card
   putatives, CPU verification on the card's samples), `cpu_pairs` (the
   CPU's GMM pairs, card matching) and `cpu_all` (CPU SIFT, pairs,
   matching and verification, the CPU's generator): views, tracks, mean
   and median reprojection error, and the share of the mean carried by
   observations above 1 px.

Prints one JSON line per stage and reading, and writes the pair-by-pair
detail to DIR/frontend24_probe.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from theiasfm_tpu_torch.matching import (  # noqa: E402
    FeatureMatcher)
from theiasfm_tpu_torch.matching.fisher_vector import (  # noqa: E402
    FisherVectorExtractor, FisherVectorOptions,
    select_image_pairs_from_global_descriptors)
from theiasfm_tpu_torch.sfm.pipeline import (  # noqa: E402
    geometric_verification as gvm)
from theiasfm_tpu_torch.sfm.reconstruction_builder import (  # noqa: E402
    ReconstructionBuilderOptions)

N_VIEWS = 24
PRIORS = dict(image_width=640, image_height=480, focal_length=600.0,
              principal_point=(320.0, 240.0))


def emit(what, **fields):
    print(json.dumps(dict(probe=what, **fields), default=float), flush=True)


def features(views, device):
    feats = cs.extract_sift_batch(views, cs.SiftOptions(), device=device)
    return [(np.asarray(k), np.asarray(d), np.asarray(v))
            for k, d, v in feats]


def fv_pairs(arrays, names, device):
    """ReconstructionBuilder's Fisher-vector pair selection (8
    neighbours) on `device`."""
    opts = ReconstructionBuilderOptions()
    fv = FisherVectorExtractor(FisherVectorOptions(
        num_gmm_clusters=opts.num_gmm_clusters_for_fisher_vector,
        max_num_features_for_training=opts
        .max_num_features_for_fisher_vector_training), device=device)
    fv.train(np.concatenate([arrays[n][1] for n in names]))
    g = {n: fv.extract_global_descriptor(arrays[n][1]) for n in names}
    return [tuple(p) for p in
            select_image_pairs_from_global_descriptors(g, 8)]


def database(arrays):
    return cs.features_db_from_arrays(arrays, {n: PRIORS for n in arrays})


def match(arrays, pairs, device, seed=0, verify=True, spy=None):
    """A FeatureMatcher's database of `pairs` on `device`."""
    db = database(arrays)
    m = FeatureMatcher(cs.FeatureMatcherOptions(
        seed=seed, perform_geometric_verification=verify), db,
        device=device)
    m.add_images(sorted(arrays))
    m.set_image_pairs_to_match(pairs)
    with spy or cs.contextlib.nullcontext():
        m.match_images()
    return db


class Recorder:
    """Keeps every verify_matches_batch call's arguments and the samples
    the card drew."""

    def __init__(self):
        self.calls = []
        self._draw = gvm.draw_verification_samples
        self._verify = gvm.verify_matches_batch

    def __enter__(self):
        def draw(*a, **k):
            out = self._draw(*a, **k)
            self.calls[-1]["samples"] = out
            return out

        def verify(*a, **k):
            self.calls.append(dict(args=a, kwargs=k))
            return self._verify(*a, **k)
        gvm.draw_verification_samples = draw
        gvm.verify_matches_batch = verify
        return self

    def __exit__(self, *exc):
        gvm.draw_verification_samples = self._draw
        gvm.verify_matches_batch = self._verify


def cpu_verify_db(arrays, calls):
    """The card's verification calls rerun on the CPU with the card's
    samples, stored as FeatureMatcher stores them: a database that
    differs from the card's only in the verification's device."""
    db = database(arrays)
    for call in calls:
        s = call["samples"]
        args = [cs._to_cpu(a) for a in call["args"][1:]]
        kw = {k: cs._to_cpu(v) for k, v in call["kwargs"].items()}
        kw["device"] = "cpu"
        infos, corrs = gvm.verify_matches_batch(
            gvm.VerificationSamples(s.essential.cpu(), s.homography.cpu()),
            *args, **kw)
        for (a, b), info, corr in zip(call["names"], infos, corrs):
            if info is not None:
                db.put_match(a, b, cs_match(a, b, info, corr))
    return db


def cs_match(a, b, info, corr):
    from theiasfm_tpu_torch.matching.database import ImagePairMatch
    return ImagePairMatch(image1=a, image2=b, twoview_info=info,
                          correspondences=corr)


def corr_set(m, nd=2):
    return set(map(tuple, np.round(np.asarray(m.correspondences,
                                              np.float64), nd)))


def pair_diff(db_a, db_b):
    """Per pair of either database: matches (or verified
    correspondences) only in a, only in b, the counts, and the rotation
    difference (deg) where both verify it."""
    out = {}
    keys = set(db_a.image_pairs_of_matches()) | set(
        db_b.image_pairs_of_matches())
    for a, b in sorted(keys):
        ma, mb = db_a.get_match(a, b), db_b.get_match(a, b)
        rec = dict(a=None if ma is None else len(ma.correspondences),
                   b=None if mb is None else len(mb.correspondences))
        if ma is not None and mb is not None:
            sa, sb = corr_set(ma), corr_set(mb)
            rec.update(only_a=len(sa - sb), only_b=len(sb - sa),
                       rot_deg=cs._rotation_error_deg(
                           ma.twoview_info.rotation_2,
                           mb.twoview_info.rotation_2))
        out[f"{a[4:]}-{b[4:]}"] = rec
    return out


def diff_summary(d):
    both = [r for r in d.values() if r["a"] is not None and
            r["b"] is not None]
    return dict(
        pairs=len(d), only_a_pairs=sum(r["b"] is None for r in d.values()),
        only_b_pairs=sum(r["a"] is None for r in d.values()),
        identical=sum(r["only_a"] == 0 and r["only_b"] == 0 for r in both),
        matches_a=sum(r["a"] for r in both),
        only_a=sum(r["only_a"] for r in both),
        only_b=sum(r["only_b"] for r in both),
        max_rot_deg=max((r["rot_deg"] for r in both), default=0.0))


def model_reading(db, names, cams, seed, device):
    opts = ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL",
        incremental_options=cs.tinc.IncrementalOptions(seed=seed))
    b = cs.ReconstructionBuilder(opts, db, device=device)
    for n in names:
        b.add_image(n)
    models = b.build_reconstruction()
    rep = cs.model_report(models[0], cams)
    errs = cs._reprojection_errors(models[0],
                                   sorted(models[0].estimated_views()))
    big = errs > 1.0
    return dict({k: rep[k] for k in (
        "views_estimated", "tracks_estimated", "reproj_mean_px",
        "reproj_median_px", "observations")},
        above_1px=int(big.sum()),
        mean_share_above_1px=float(errs[big].sum() / max(errs.sum(), 1e-12)),
        mean_without_above_1px=float(errs[~big].mean()) if errs.size
        else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default="frontend24_probe_out")
    ap.add_argument("--views", type=int, default=N_VIEWS)
    ap.add_argument("--device", default="cuda",
                    help="the card's side (cpu only to rehearse)")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda":
        cs.phase_env()
    views, cams = cs.render_synthetic_views(cs._texture(0), args.views,
                                            (640, 480), focal=600.0)
    names = [f"view{i:03d}" for i in range(args.views)]
    detail = {}

    fc, fp = features(views, dev), features(views, "cpu")
    card = {n: (k[v], d[v]) for n, (k, d, v) in zip(names, fc)}
    cpu = {n: (k[v], d[v]) for n, (k, d, v) in zip(names, fp)}
    emit("sift", card=[int(v.sum()) for _, _, v in fc],
         cpu=[int(v.sum()) for _, _, v in fp],
         card_on_cpu=[cs._kp_agree(a, b) for a, b in zip(fc, fp)],
         cpu_on_card=[cs._kp_agree(b, a) for a, b in zip(fc, fp)])

    pc = fv_pairs(card, names, dev)
    pp = fv_pairs(card, names, "cpu")
    ppp = fv_pairs(cpu, names, "cpu")
    emit("pairs", card=len(pc), cpu_on_card_features=len(pp),
         cpu_on_cpu_features=len(ppp), common_card_cpu=len(set(pc) & set(pp)),
         common_card_cpu_all=len(set(pc) & set(ppp)))
    detail["pairs"] = dict(card=pc, cpu=pp, cpu_all=ppp)

    put = pair_diff(match(card, pc, dev, verify=False),
                    match(card, pc, "cpu", verify=False))
    emit("putative_card_vs_cpu", **diff_summary(put))
    detail["putative"] = put

    for seed in args.seeds:
        rec = Recorder()
        db_card = match(card, pc, dev, seed=seed, spy=rec)
        chunks = [pc[s:s + 32] for s in range(0, len(pc), 32)]
        # FeatureMatcher verifies the chunk's pairs with enough putative
        # matches, in order: name each call's rows from the card's
        # putative counts
        for call, chunk in zip(rec.calls, chunks):
            call["names"] = [p for p in chunk if (put.get(
                f"{p[0][4:]}-{p[1][4:]}", {}).get("a") or 0) >= 30]
            n_rows = call["args"][1].shape[0]
            assert len(call["names"]) == n_rows, (len(call["names"]),
                                                  n_rows)
        db_cv = cpu_verify_db(card, rec.calls)
        ver = pair_diff(db_card, db_cv)
        emit("verified_card_vs_cpu", seed=seed, **diff_summary(ver))
        detail[f"verified_seed{seed}"] = ver
        dbs = dict(card=db_card, cpu_verify=db_cv,
                   cpu_pairs=match(card, pp, dev, seed=seed),
                   cpu_all=match(cpu, ppp, "cpu", seed=seed))
        for what, db in dbs.items():
            emit("model", seed=seed, db=what,
                 verified_pairs=len(db.image_pairs_of_matches()),
                 **model_reading(db, names, cams, seed, dev))
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "frontend24_probe.json").write_text(
        json.dumps(detail, default=float))
    if dev == "cuda":
        print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
