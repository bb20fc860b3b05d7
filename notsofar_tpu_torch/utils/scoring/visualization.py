"""Self-contained HTML alignment visualization.

Copy of notsofar_tpu/utils/scoring/visualization.py.
Capability parity with the reference's meeteval AlignmentVisualization hook
(utils/scoring.py:97-106): renders reference and hypothesis segments on a
shared timeline (one lane per speaker, hyp lanes mirrored below), with the
tcpWER speaker assignment annotated, as one standalone HTML file.
"""
import html
import json
from pathlib import Path
from typing import Dict, List, Optional

from notsofar_tpu_torch.utils.scoring.seglst import SegLst

_PALETTE = ["#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
            "#b279a2", "#ff9da6", "#9d755d"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 16px; }}
.lane-label {{ font-size: 12px; fill: #333; }}
.seg {{ opacity: 0.85; cursor: pointer; }}
.seg:hover {{ opacity: 1.0; stroke: #000; }}
.axis {{ stroke: #999; }} .tick {{ font-size: 10px; fill: #666; }}
#tip {{ position: fixed; background: #fff; border: 1px solid #888;
       padding: 6px; font-size: 12px; max-width: 480px; display: none; }}
</style></head><body>
<h3>{title}</h3>
<p>{subtitle}</p>
<div id="tip"></div>
<svg width="{width}" height="{height}">{svg}</svg>
<script>
const tip = document.getElementById('tip');
document.querySelectorAll('.seg').forEach(el => {{
  el.addEventListener('mousemove', e => {{
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.innerHTML = el.dataset.info;
  }});
  el.addEventListener('mouseleave', () => tip.style.display = 'none');
}});
</script></body></html>
"""


def render_alignment_html(ref: SegLst, hyp: SegLst, out_path,
                          assignment: Optional[List] = None,
                          title: str = "tcpWER alignment",
                          width: int = 1400):
    """Write a standalone HTML timeline of ref vs hyp segments."""
    ref_spks = sorted({s["speaker"] for s in ref})
    hyp_spks = sorted({s["speaker"] for s in hyp})
    assign_map = {}
    if assignment:
        for pair in assignment:
            r, h = pair
            if r is not None and h is not None:
                assign_map[str(h)] = str(r)

    t_max = max([float(s["end_time"]) for s in list(ref) + list(hyp)] + [1.0])
    lane_h, pad_l, pad_t = 28, 120, 30
    lanes = {("ref", s): i for i, s in enumerate(ref_spks)}
    for j, s in enumerate(hyp_spks):
        lanes[("hyp", s)] = len(ref_spks) + j + 1  # gap row between
    height = pad_t + (len(lanes) + 2) * lane_h + 30
    scale = (width - pad_l - 20) / t_max

    def color(kind, spk):
        if kind == "ref":
            return _PALETTE[ref_spks.index(spk) % len(_PALETTE)]
        mapped = assign_map.get(str(spk))
        if mapped in ref_spks:
            return _PALETTE[ref_spks.index(mapped) % len(_PALETTE)]
        return "#aaaaaa"

    parts = []
    # time axis
    parts.append(f'<line class="axis" x1="{pad_l}" y1="{pad_t - 8}" '
                 f'x2="{width - 20}" y2="{pad_t - 8}"/>')
    step = max(int(t_max // 12), 1)
    for t in range(0, int(t_max) + 1, step):
        x = pad_l + t * scale
        parts.append(f'<line class="axis" x1="{x:.1f}" y1="{pad_t - 12}" '
                     f'x2="{x:.1f}" y2="{pad_t - 4}"/>')
        parts.append(f'<text class="tick" x="{x:.1f}" y="{pad_t - 16}" '
                     f'text-anchor="middle">{t}s</text>')

    for (kind, spk), lane in lanes.items():
        y = pad_t + lane * lane_h
        label = f"{kind}:{spk}"
        if kind == "hyp" and str(spk) in assign_map:
            label += f" → {assign_map[str(spk)]}"
        parts.append(f'<text class="lane-label" x="4" y="{y + 16}">'
                     f'{html.escape(label)}</text>')
        source = ref if kind == "ref" else hyp
        for seg in source:
            if seg["speaker"] != spk:
                continue
            x0 = pad_l + float(seg["start_time"]) * scale
            w = max((float(seg["end_time"]) - float(seg["start_time"])) * scale,
                    2.0)
            info = html.escape(json.dumps({
                "speaker": str(spk),
                "start": float(seg["start_time"]),
                "end": float(seg["end_time"]),
                "words": str(seg["words"])[:400]}, indent=0))
            parts.append(
                f'<rect class="seg" x="{x0:.1f}" y="{y + 4}" width="{w:.1f}" '
                f'height="{lane_h - 8}" rx="3" fill="{color(kind, spk)}" '
                f"data-info='{info}'/>")

    subtitle = (f"{len(ref_spks)} reference speakers, {len(hyp_spks)} "
                f"hypothesis speakers; hyp lanes colored by their assigned "
                f"reference speaker")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(_TEMPLATE.format(
        title=html.escape(title), subtitle=html.escape(subtitle),
        width=width, height=height, svg="".join(parts)))
    return str(out_path)
