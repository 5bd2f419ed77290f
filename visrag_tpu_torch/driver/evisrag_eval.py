"""EVisRAG evaluation driver (the port's copy of visrag_tpu/driver/
evisrag_eval.py, itself at parity with the reference eval.py:160-190):
joins preds jsonl with gold by qid, replaces insufficient golds with the
refusal set, reports global/issuff/unsuff EM/Acc/F1.

    python -m visrag_tpu_torch.driver.evisrag_eval --gold gold.jsonl --preds preds.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gold", required=True,
                    help="jsonl rows {qid, answer, is_sufficient}")
    ap.add_argument("--preds", required=True, help="jsonl rows {qid, pred}")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    from ..generation.qa_eval import INSUFFICIENT_GOLD, evaluate_qa

    gold = {}
    with open(args.gold) as f:
        for line in f:
            row = json.loads(line)
            gold[row["qid"]] = (row["answer"], row.get("is_sufficient", True))

    preds, golds, suff = [], [], []
    with open(args.preds) as f:
        for line in f:
            row = json.loads(line)
            qid = row["qid"]
            if qid not in gold:
                print(f"{qid} not in gold!", file=sys.stderr)
                return 1
            ans, is_suff = gold[qid]
            if not is_suff:
                ans = INSUFFICIENT_GOLD
            elif isinstance(ans, str):
                ans = [ans]
            preds.append(row["pred"])
            golds.append(ans)
            suff.append(is_suff)

    results = evaluate_qa(preds, golds, suff)
    print(json.dumps(results, indent=1))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
