"""AMT-style A/B user-study tooling, and its command line.

Counterpart of monkeynet_tpu/utils/user_study.py and scripts/user_study.py
(the JAX package's), with the same behaviour, outputs and messages; it is
pure Python and imports neither package.

The reference ships the *artifacts* of its Mechanical Turk study —
randomized pair manifests (``sup-mat/user-study/*.csv``, schema
``first,second,appearance``) and the HIT page template
(``sup-mat/user-study/amt_transfer.html`` / ``amt_prediction.html``).
This module produces and consumes them for your own runs:

- :func:`make_manifest` pairs two methods' rendered outputs (matched by a
  shared clip id, e.g. ``ours-00003816.gif`` vs ``theirs-00003816.gif``,
  the reference's naming convention in e.g.
  ``sup-mat/user-study/mocogan-taichi.csv:2``) and randomizes which lands
  in the "first" (Option A) column per row with a seeded RNG, so rater
  position bias cancels. Header ``first,second,appearance``, as the
  reference CSVs.
- :func:`render_study_page` emits a self-contained HTML page for the
  manifest. Two flavors: ``template`` keeps AMT's ``${first}``/
  ``${second}``/``${video}`` placeholders for upload as a HIT template;
  ``local`` inlines one <section> per row with relative src paths and a
  radio form that downloads a responses CSV — a zero-dependency local
  study (no CDN, unlike the reference template).
- :func:`analyze_responses` joins raters' A/B choices back through the
  manifest to undo the randomization and reports, per method: vote share,
  a 95% Wilson confidence interval, and a two-sided sign-test p-value
  (exact binomial, computed in pure Python — no scipy).

The five findings that ADVICE.md records against the JAX package's copy
(media links under ``make``'s prefix, clip ids from the last digit run,
method names visible in src paths, ``page``'s KeyError on a manifest
without its key, the 3-column manifest header only) hold for this copy
too: it keeps that behaviour, so both copies give the same files.

    # 1. Pair two methods' gifs (matched by shared clip id), randomize A/B:
    python -m monkeynet_tpu_torch.utils.user_study make \
        --ours log/taichi/transfer/gifs --baseline /path/to/x2face-gifs \
        --appearance log/taichi/transfer/appearance \
        --study-name ours-vs-x2face --out study/

    # 2. Render the page (local self-contained flavor, or an AMT template):
    python -m monkeynet_tpu_torch.utils.user_study page --manifest-dir study/ --mode transfer
    python -m monkeynet_tpu_torch.utils.user_study page --manifest-dir study/ --flavor template

    # 3. Raters open study/index.html, answer, download responses.csv. Then:
    python -m monkeynet_tpu_torch.utils.user_study analyze \
        --responses responses.csv --key study/key.csv
"""

from __future__ import annotations

import csv
import html
import math
import os
import random
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MANIFEST_FIELDS = ("first", "second", "appearance")

_ID_RE = re.compile(r"(\d+)")


def _clip_id(filename: str) -> Optional[str]:
    """Shared clip id: the last digit run in the stem.

    Matches the reference's naming (``mocogan-00003816.gif`` and
    ``mtm-00003816.gif`` pair on ``00003816``).
    """
    stem = os.path.splitext(os.path.basename(filename))[0]
    runs = _ID_RE.findall(stem)
    return runs[-1] if runs else None


def _index_by_id(directory: str, exts: Sequence[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for name in sorted(os.listdir(directory)):
        if os.path.splitext(name)[1].lower() not in exts:
            continue
        cid = _clip_id(name)
        if cid is None:
            continue
        if cid in out:
            raise ValueError(
                f"duplicate clip id {cid!r} in {directory}: "
                f"{out[cid]!r} and {name!r}"
            )
        out[cid] = name
    return out


@dataclass(frozen=True)
class ManifestRow:
    first: str
    second: str
    appearance: str
    # Which side holds "ours" for this row — recorded in the sidecar key
    # file, never in the manifest itself (raters must not see it).
    ours_is_first: bool


def make_manifest(
    ours_dir: str,
    baseline_dir: str,
    appearance_dir: Optional[str] = None,
    *,
    study_name: str = "study",
    seed: int = 0,
    video_exts: Sequence[str] = (".gif", ".mp4"),
    image_exts: Sequence[str] = (".jpg", ".jpeg", ".png"),
) -> List[ManifestRow]:
    """Pair the two methods' outputs and randomize A/B placement.

    Rows are ordered by a seeded shuffle of the shared clip ids (the
    reference manifests are shuffled too — ids in
    ``sup-mat/user-study/*.csv`` are not sorted). Paths are prefixed with
    ``study_name/`` exactly like the reference rows prefix their study
    directory.
    """
    ours = _index_by_id(ours_dir, video_exts)
    base = _index_by_id(baseline_dir, video_exts)
    shared = sorted(set(ours) & set(base))
    if not shared:
        raise ValueError(
            f"no shared clip ids between {ours_dir} and {baseline_dir}"
        )
    appearance: Dict[str, str] = {}
    if appearance_dir is not None:
        appearance = _index_by_id(appearance_dir, image_exts)
        missing = [cid for cid in shared if cid not in appearance]
        if missing:
            raise ValueError(
                f"appearance images missing for clip ids {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''} in {appearance_dir}"
            )

    rng = random.Random(seed)
    order = list(shared)
    rng.shuffle(order)
    rows = []
    for cid in order:
        ours_first = rng.random() < 0.5
        a = f"{study_name}/{ours[cid]}"
        b = f"{study_name}/{base[cid]}"
        rows.append(
            ManifestRow(
                first=a if ours_first else b,
                second=b if ours_first else a,
                appearance=f"{study_name}/{appearance[cid]}" if appearance else "",
                ours_is_first=ours_first,
            )
        )
    return rows


def write_manifest(rows: Iterable[ManifestRow], path: str) -> None:
    """Reference-schema CSV: header ``first,second,appearance``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(MANIFEST_FIELDS)
        for r in rows:
            w.writerow([r.first, r.second, r.appearance])


def write_key(rows: Iterable[ManifestRow], path: str) -> None:
    """Sidecar answer key (kept OUT of the manifest raters see)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["first", "ours_is_first"])
        for r in rows:
            w.writerow([r.first, int(r.ours_is_first)])


def read_manifest(path: str) -> List[Tuple[str, str, str]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if tuple(reader.fieldnames or ()) != MANIFEST_FIELDS:
            raise ValueError(
                f"{path}: expected header {MANIFEST_FIELDS}, "
                f"got {reader.fieldnames}"
            )
        return [(r["first"], r["second"], r["appearance"]) for r in reader]


_INSTRUCTIONS = {
    "transfer": (
        "Indicate which of the two videos better matches the reference: "
        "similar movement (same gesture, same direction), and if equally "
        "similar, whichever looks more realistic."
    ),
    "prediction": (
        "Indicate which of the two videos is a more plausible continuation: "
        "natural motion, and if equally plausible, whichever looks more "
        "realistic."
    ),
}


def render_study_page(
    rows: Sequence[ManifestRow],
    *,
    mode: str = "transfer",
    flavor: str = "local",
    asset_prefix: str = "",
) -> str:
    """Build the study HTML.

    ``flavor='template'`` → one A/B section with ``${first}``/``${second}``
    /``${video}`` placeholders, the AMT HIT-template contract
    (``sup-mat/user-study/amt_transfer.html`` substitutes one manifest row
    per HIT). ``flavor='local'`` → the whole manifest inlined, radio
    buttons per row, and a button that serializes answers to a
    ``responses.csv`` download; works from file:// with zero external
    dependencies.
    """
    if mode not in _INSTRUCTIONS:
        raise ValueError(f"mode must be one of {sorted(_INSTRUCTIONS)}")
    if flavor not in ("local", "template"):
        raise ValueError("flavor must be 'local' or 'template'")
    instructions = _INSTRUCTIONS[mode]

    def media(src: str) -> str:
        src = html.escape(asset_prefix + src)
        if src.endswith(".mp4"):
            return (
                f'<video src="{src}" width="192" autoplay loop muted></video>'
            )
        return f'<img src="{src}" width="192">'

    sections = []
    if flavor == "template":
        sections.append(_section(0, media("${video}"), media("${first}"),
                                 media("${second}"), template=True))
    else:
        for i, r in enumerate(rows):
            ref = media(r.appearance) if r.appearance else ""
            sections.append(
                _section(i, ref, media(r.first), media(r.second),
                         template=False, first_path=r.first)
            )
    body = "\n".join(sections)
    script = _LOCAL_SCRIPT if flavor == "local" else ""
    submit = (
        '<button id="export" type="button">Download responses.csv</button>'
        if flavor == "local"
        else ""
    )
    return _PAGE_SHELL.format(
        instructions=html.escape(instructions),
        body=body,
        submit=submit,
        script=script,
    )


def _section(i, ref_html, a_html, b_html, *, template, first_path=""):
    name = "choice" if template else f"choice{i}"
    tag = "" if template else (
        f'<input type="hidden" class="row-first" value="{html.escape(first_path)}">'
    )
    ref_block = (
        f'<div class="cell"><div class="label">Reference</div>{ref_html}</div>'
        if ref_html
        else ""
    )
    return f"""<section class="pair" data-row="{i}">{tag}
  {ref_block}
  <div class="cell"><label><input type="radio" name="{name}" value="optionA" required> Option A</label>{a_html}</div>
  <div class="cell"><label><input type="radio" name="{name}" value="optionB" required> Option B</label>{b_html}</div>
</section>"""


_PAGE_SHELL = """<!doctype html>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width,initial-scale=1">
<title>monkeynet_tpu user study</title>
<style>
body {{ font-family: sans-serif; margin: 2rem; max-width: 72rem; }}
.pair {{ display: flex; gap: 1.5rem; padding: 1rem 0; border-bottom: 1px solid #ddd; }}
.cell {{ text-align: center; }}
.cell .label, .cell label {{ display: block; margin-bottom: .4rem; font-weight: 600; }}
#export {{ margin-top: 1.5rem; padding: .6rem 1.2rem; font-size: 1rem; }}
</style>
<p><strong>Instructions:</strong> {instructions}</p>
<form id="study">
{body}
{submit}
</form>
{script}
"""

_LOCAL_SCRIPT = """<script>
document.getElementById('export').addEventListener('click', function () {
  var rows = ['first,choice'];
  var ok = true;
  document.querySelectorAll('section.pair').forEach(function (sec) {
    var picked = sec.querySelector('input[type=radio]:checked');
    if (!picked) { ok = false; return; }
    var first = sec.querySelector('.row-first').value;
    rows.push('"' + first.replace(/"/g, '""') + '",' + picked.value);
  });
  if (!ok) { alert('Please answer every pair.'); return; }
  var blob = new Blob([rows.join('\\n') + '\\n'], {type: 'text/csv'});
  var a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = 'responses.csv';
  a.click();
});
</script>"""


@dataclass(frozen=True)
class StudyResult:
    n: int
    ours_votes: int
    ours_share: float
    ci95: Tuple[float, float]
    p_value: float


def analyze_responses(
    responses_path: str, key_path: str
) -> StudyResult:
    """Undo the A/B randomization and score the study.

    ``responses.csv`` rows are ``first,choice`` with choice in
    {optionA, optionB} (multiple raters may repeat a ``first``; every row
    counts as one vote). The key maps ``first`` → whether ours sat in the
    A slot. Reports ours' vote share, a 95% Wilson interval, and an exact
    two-sided binomial sign test against the p=0.5 null.
    """
    key: Dict[str, bool] = {}
    with open(key_path, newline="") as f:
        for row in csv.DictReader(f):
            key[row["first"]] = bool(int(row["ours_is_first"]))
    n = 0
    ours = 0
    with open(responses_path, newline="") as f:
        for row in csv.DictReader(f):
            first = row["first"]
            if first not in key:
                raise ValueError(f"response row {first!r} not in key")
            choice = row["choice"].strip()
            if choice not in ("optionA", "optionB"):
                raise ValueError(f"bad choice {choice!r} for {first!r}")
            picked_first = choice == "optionA"
            n += 1
            if picked_first == key[first]:
                ours += 1
    if n == 0:
        raise ValueError("no responses")
    share = ours / n
    return StudyResult(
        n=n,
        ours_votes=ours,
        ours_share=share,
        ci95=_wilson(ours, n),
        p_value=_binom_two_sided(ours, n),
    )


def _wilson(k: int, n: int, z: float = 1.959964) -> Tuple[float, float]:
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def _binom_two_sided(k: int, n: int) -> float:
    """Exact two-sided sign test vs p=0.5: sum of P[X=i] ≤ P[X=k]."""
    # log C(n, i) via lgamma for numerical safety at large n.
    def logpmf(i: int) -> float:
        return (
            math.lgamma(n + 1)
            - math.lgamma(i + 1)
            - math.lgamma(n - i + 1)
            - n * math.log(2.0)
        )

    lk = logpmf(k)
    total = 0.0
    for i in range(n + 1):
        if logpmf(i) <= lk + 1e-12:
            total += math.exp(logpmf(i))
    return min(1.0, total)


def main(argv=None) -> None:
    from argparse import ArgumentParser

    p = ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    mk = sub.add_parser("make", help="build manifest.csv + key.csv")
    mk.add_argument("--ours", required=True)
    mk.add_argument("--baseline", required=True)
    mk.add_argument("--appearance", default=None)
    mk.add_argument("--study-name", default="study")
    mk.add_argument("--seed", type=int, default=0)
    mk.add_argument("--out", default="study")

    pg = sub.add_parser("page", help="render index.html for a manifest dir")
    pg.add_argument("--manifest-dir", required=True)
    pg.add_argument("--mode", default="transfer",
                    choices=["transfer", "prediction"])
    pg.add_argument("--flavor", default="local",
                    choices=["local", "template"])
    pg.add_argument("--asset-prefix", default="",
                    help="prefix prepended to every media src")

    an = sub.add_parser("analyze", help="score responses against the key")
    an.add_argument("--responses", required=True)
    an.add_argument("--key", required=True)

    opt = p.parse_args(argv)

    if opt.cmd == "make":
        rows = make_manifest(
            opt.ours, opt.baseline, opt.appearance,
            study_name=opt.study_name, seed=opt.seed,
        )
        os.makedirs(opt.out, exist_ok=True)
        write_manifest(rows, os.path.join(opt.out, "manifest.csv"))
        write_key(rows, os.path.join(opt.out, "key.csv"))
        print(f"{len(rows)} pairs -> {opt.out}/manifest.csv (+ key.csv)")
    elif opt.cmd == "page":
        rows = []
        key = {}
        with open(os.path.join(opt.manifest_dir, "key.csv"), newline="") as f:
            for r in csv.DictReader(f):
                key[r["first"]] = bool(int(r["ours_is_first"]))
        for first, second, appearance in read_manifest(
            os.path.join(opt.manifest_dir, "manifest.csv")
        ):
            rows.append(ManifestRow(first, second, appearance, key[first]))
        page = render_study_page(
            rows, mode=opt.mode, flavor=opt.flavor,
            asset_prefix=opt.asset_prefix,
        )
        out = os.path.join(opt.manifest_dir, "index.html")
        with open(out, "w") as f:
            f.write(page)
        print(f"wrote {out} ({opt.flavor}, {len(rows)} pairs)")
    else:
        res = analyze_responses(opt.responses, opt.key)
        lo, hi = res.ci95
        print(
            f"n={res.n} votes, ours preferred {res.ours_votes} "
            f"({100 * res.ours_share:.1f}%), 95% CI "
            f"[{100 * lo:.1f}%, {100 * hi:.1f}%], sign-test p={res.p_value:.4g}"
        )


if __name__ == "__main__":
    main()
