"""Standalone scorer CLI: `python -m notsofar_tpu_torch.utils.scoring`.

Copy of notsofar_tpu/utils/scoring/__main__.py.
Parity surface for the meeteval CLI the reference ecosystem ships
(`meeteval-wer tcpwer -r ref.json -h hyp.json`; the reference calls the
library form from utils/scoring.py:108-125). Scores SegLST jsons
per-session and prints one JSON object with per-session and aggregate
(error-sum / length-sum) rates.
"""
import argparse
import json
import sys

from notsofar_tpu_torch.utils.scoring.seglst import SegLst
from notsofar_tpu_torch.utils.scoring.tcpwer import tcorc_wer, tcp_wer
from notsofar_tpu_torch.utils.text_norm import get_txt_norm


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m notsofar_tpu_torch.utils.scoring",
        description="Score SegLST hypothesis jsons (tcpWER / tcORC-WER).")
    parser.add_argument("metric", choices=["tcpwer", "tcorcwer"])
    parser.add_argument("-r", "--reference", required=True,
                        help="reference SegLST json")
    parser.add_argument("-H", "--hypothesis", required=True,
                        help="hypothesis SegLST json")
    parser.add_argument("--collar", type=float, default=5.0)
    parser.add_argument("--normalizer", default="chime8",
                        choices=["chime8", "lower,rm_punct", "none"],
                        help="text normalization applied to both sides")
    args = parser.parse_args(argv)

    ref = SegLst.load(args.reference)
    hyp = SegLst.load(args.hypothesis)
    if args.normalizer != "none":
        tn = get_txt_norm(args.normalizer)
        ref = ref.normalize_words(tn)
        hyp = hyp.normalize_words(tn)

    score = tcp_wer if args.metric == "tcpwer" else tcorc_wer
    ref_by_session = ref.groupby("session_id")
    hyp_by_session = hyp.groupby("session_id")
    unknown = sorted(set(hyp_by_session) - set(ref_by_session))
    if unknown:
        parser.error(f"hypothesis sessions missing from reference: {unknown}")

    per_session = {}
    errors = length = 0
    for sid, ref_s in sorted(ref_by_session.items()):
        res = score(ref_s, hyp_by_session.get(sid, SegLst([])),
                    collar=args.collar)
        res.pop("assignment", None)
        per_session[sid] = res
        errors += res["errors"]
        length += res["length"]

    out = dict(
        metric=args.metric, collar=args.collar,
        error_rate=errors / length if length else float(errors > 0),
        errors=errors, length=length, sessions=per_session)
    json.dump(out, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
