"""Streaming evaluators: metrics accumulated across batches on the host
(paddle_tpu/evaluator.py, the reference's gserver/evaluators: classification
accuracy, precision/recall, AUC, chunk F1, edit distance, detection mAP,
rank AUC, positive/negative pairs and a value printer).

The per-batch tensor work (argmax, top-k, IoU) runs in the program; an
evaluator is a numpy accumulator fed with fetched arrays, or tensors that
it hands back to the host (`_host`), so it composes with any fetch list.
Each follows reset()/update()/eval().
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _host(x):
    """A fetched value as numpy: tensors (on any device, bf16 widened to
    f32) copied to the host, anything else through np.asarray."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


__all__ = [
    "Evaluator",
    "Accuracy",
    "PrecisionRecall",
    "Auc",
    "ChunkEvaluator",
    "EditDistance",
    "DetectionMAP",
    "RankAuc",
    "PnPair",
    "ValuePrinter",
]


class Evaluator:
    """reset() → update(batch…) per batch → eval() for the pass value."""

    name: str = "evaluator"

    def reset(self) -> None:
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.eval()!r})"


class Accuracy(Evaluator):
    """Classification accuracy (gserver ClassificationErrorEvaluator,
    Evaluator.cpp:172 — reported there as error rate; here as accuracy,
    matching the in-graph `accuracy` op)."""

    name = "accuracy"

    def __init__(self):
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0

    def update(self, pred, label) -> float:
        """pred: [N, C] scores or [N] class ids; label: [N] or [N,1]."""
        pred = _host(pred)
        label = _host(label).reshape(-1)
        ids = pred.argmax(axis=-1) if pred.ndim > 1 else pred
        ids = ids.reshape(-1)
        c = int((ids == label).sum())
        self._correct += c
        self._total += label.size
        return c / max(label.size, 1)

    def eval(self) -> float:
        return self._correct / max(self._total, 1)


class PrecisionRecall(Evaluator):
    """Multi-class precision/recall/F1 (gserver PrecisionRecallEvaluator,
    Evaluator.cpp:514). eval() returns macro averages; per-class stats via
    eval_all(). Binary problems with class_dim=2 report the positive class."""

    name = "precision_recall"

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._tp = np.zeros(self.num_classes, np.int64)
        self._fp = np.zeros(self.num_classes, np.int64)
        self._fn = np.zeros(self.num_classes, np.int64)

    def update(self, pred, label):
        pred = _host(pred)
        label = _host(label).reshape(-1)
        ids = (pred.argmax(axis=-1) if pred.ndim > 1 else pred).reshape(-1)
        for c in range(self.num_classes):
            p, l = ids == c, label == c
            self._tp[c] += int((p & l).sum())
            self._fp[c] += int((p & ~l).sum())
            self._fn[c] += int((~p & l).sum())

    def eval_all(self) -> Dict[str, np.ndarray]:
        tp, fp, fn = self._tp, self._fp, self._fn
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
            rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
            f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
        return {"precision": prec, "recall": rec, "f1": f1}

    def eval(self) -> Tuple[float, float, float]:
        s = self.eval_all()
        if self.num_classes == 2:
            return (float(s["precision"][1]), float(s["recall"][1]), float(s["f1"][1]))
        return (
            float(s["precision"].mean()),
            float(s["recall"].mean()),
            float(s["f1"].mean()),
        )


class Auc(Evaluator):
    """ROC AUC via fixed-resolution score histograms — the streaming scheme
    the reference uses (AucEvaluator, Evaluator.cpp:595: bucketed
    statPos_/statNeg_), O(buckets) memory regardless of dataset size."""

    name = "auc"

    def __init__(self, num_thresholds: int = 4096):
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, score, label):
        """score: [N] or [N,2] (positive-class prob taken); label: [N] 0/1."""
        score = _host(score)
        if score.ndim > 1:
            score = score[..., 1] if score.shape[-1] == 2 else score.reshape(-1)
        score = np.clip(score.reshape(-1), 0.0, 1.0)
        label = _host(label).reshape(-1).astype(bool)
        idx = (score * self.num_thresholds).astype(np.int64)
        np.add.at(self._pos, idx[label], 1)
        np.add.at(self._neg, idx[~label], 1)

    def eval(self) -> float:
        # sweep thresholds high→low accumulating TPR/FPR; trapezoid rule
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.0
        tpr = tp / tot_p
        fpr = fp / tot_n
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        return float(trapezoid(tpr, fpr))


def _extract_chunks(
    labels: Sequence[int],
    scheme: str,
    num_chunk_types: int,
) -> List[Tuple[int, int, int]]:
    """Decode a tag sequence into (type, begin, end) chunks.

    Tag layout matches the reference (ChunkEvaluator.cpp): for IOB each type
    t has tags 2t (B) and 2t+1 (I); IOE uses 2t (I) 2t+1 (E); IOBES uses
    4t..4t+3 (B I E S); `plain` gives one tag per type. The largest id is
    "outside" in every scheme.
    """
    scheme = scheme.lower()
    chunks = []
    start, ctype = None, None

    def close(end):
        nonlocal start, ctype
        if start is not None:
            chunks.append((ctype, start, end))
        start, ctype = None, None

    n_tag = {"iob": 2, "ioe": 2, "iobes": 4, "plain": 1}[scheme]
    outside = num_chunk_types * n_tag
    for i, tag in enumerate(list(labels) + [outside]):
        if tag == outside or tag > outside:
            close(i)
            continue
        t, pos = divmod(tag, n_tag)
        if scheme == "plain":
            if ctype != t:
                close(i)
                start, ctype = i, t
        elif scheme == "iob":
            if pos == 0:  # B
                close(i)
                start, ctype = i, t
            elif ctype != t:  # I with wrong/absent open chunk
                close(i)
                start, ctype = i, t
        elif scheme == "ioe":
            if ctype != t:
                close(i)
                start, ctype = i, t
            if pos == 1:  # E closes inclusive
                close(i + 1)
        elif scheme == "iobes":
            if pos == 3:  # S
                close(i)
                chunks.append((t, i, i + 1))
            elif pos == 0:  # B
                close(i)
                start, ctype = i, t
            else:  # I or E
                if ctype != t:
                    close(i)
                    start, ctype = i, t
                if pos == 2:  # E
                    close(i + 1)
    return chunks


class ChunkEvaluator(Evaluator):
    """Chunk (NER) F1 (gserver ChunkEvaluator.cpp; registry name "chunk").

    update() takes per-sequence predicted and label tag lists; supports
    IOB / IOE / IOBES / plain schemes.
    """

    name = "chunk"

    def __init__(self, num_chunk_types: int, chunk_scheme: str = "iob"):
        self.num_chunk_types = num_chunk_types
        self.scheme = chunk_scheme
        self.reset()

    def reset(self):
        self._guessed = 0
        self._labeled = 0
        self._correct = 0

    def update_sequence(self, pred_tags, label_tags):
        g = _extract_chunks(_host(pred_tags).tolist(), self.scheme, self.num_chunk_types)
        l = _extract_chunks(_host(label_tags).tolist(), self.scheme, self.num_chunk_types)
        self._guessed += len(g)
        self._labeled += len(l)
        self._correct += len(set(g) & set(l))

    def update(self, pred_tags_batch, label_tags_batch):
        for p, l in zip(pred_tags_batch, label_tags_batch):
            self.update_sequence(p, l)

    def eval(self) -> Tuple[float, float, float]:
        prec = self._correct / max(self._guessed, 1)
        rec = self._correct / max(self._labeled, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (prec, rec, f1)


def _levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


class EditDistance(Evaluator):
    """Sequence edit distance, optionally length-normalized — the CTC error
    metric (gserver CTCErrorEvaluator.cpp; fluid edit_distance_op)."""

    name = "edit_distance"

    def __init__(self, normalized: bool = True):
        self.normalized = normalized
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0
        self._seq_errors = 0

    def update_sequence(self, hyp, ref) -> float:
        hyp = [int(v) for v in _host(hyp).reshape(-1)]
        ref = [int(v) for v in _host(ref).reshape(-1)]
        d = _levenshtein(hyp, ref)
        v = d / max(len(ref), 1) if self.normalized else float(d)
        self._sum += v
        self._count += 1
        self._seq_errors += int(d > 0)
        return v

    def update(self, hyps, refs):
        for h, r in zip(hyps, refs):
            self.update_sequence(h, r)

    def eval(self) -> float:
        return self._sum / max(self._count, 1)

    @property
    def instance_error_rate(self) -> float:
        return self._seq_errors / max(self._count, 1)


def _iou(box, boxes) -> np.ndarray:
    """box: [4] (xmin,ymin,xmax,ymax); boxes: [M,4] → IoU [M]."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.clip(ix2 - ix1, 0, None)
    ih = np.clip(iy2 - iy1, 0, None)
    inter = iw * ih
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


class DetectionMAP(Evaluator):
    """VOC-style detection mAP (gserver DetectionMAPEvaluator.cpp;
    11-point or integral AP, IoU-threshold matching, one-to-one greedy)."""

    name = "detection_map"

    def __init__(self, num_classes: int, overlap_threshold: float = 0.5,
                 ap_version: str = "integral"):
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        if ap_version not in ("integral", "11point"):
            raise ValueError(f"ap_version {ap_version!r}")
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        # per class: list of (score, is_tp); ground-truth count
        self._scored: List[List[Tuple[float, int]]] = [
            [] for _ in range(self.num_classes)
        ]
        self._n_gt = np.zeros(self.num_classes, np.int64)

    def update_image(self, detections, gt_boxes, gt_labels):
        """detections: [K, 6] rows (label, score, xmin, ymin, xmax, ymax);
        gt_boxes: [M, 4]; gt_labels: [M]."""
        detections = _host(detections).astype(np.float64).reshape(-1, 6)
        gt_boxes = _host(gt_boxes).astype(np.float64).reshape(-1, 4)
        gt_labels = _host(gt_labels).reshape(-1).astype(int)
        for c in gt_labels:
            self._n_gt[c] += 1
        for c in range(self.num_classes):
            dets = detections[detections[:, 0].astype(int) == c]
            gts = gt_boxes[gt_labels == c]
            order = np.argsort(-dets[:, 1])
            used = np.zeros(len(gts), bool)
            for i in order:
                score, box = dets[i, 1], dets[i, 2:6]
                if len(gts) == 0:
                    self._scored[c].append((score, 0))
                    continue
                ious = _iou(box, gts)
                ious[used] = -1.0
                j = int(np.argmax(ious))
                if ious[j] >= self.overlap_threshold:
                    used[j] = True
                    self._scored[c].append((score, 1))
                else:
                    self._scored[c].append((score, 0))

    def update(self, detections_batch, gt_boxes_batch, gt_labels_batch):
        for d, b, l in zip(detections_batch, gt_boxes_batch, gt_labels_batch):
            self.update_image(d, b, l)

    def _ap(self, c: int) -> Optional[float]:
        if self._n_gt[c] == 0:
            return None
        rows = sorted(self._scored[c], key=lambda t: -t[0])
        if not rows:
            return 0.0
        tp = np.cumsum([r[1] for r in rows])
        fp = np.cumsum([1 - r[1] for r in rows])
        rec = tp / self._n_gt[c]
        prec = tp / np.maximum(tp + fp, 1)
        if self.ap_version == "11point":
            return float(
                np.mean([prec[rec >= t].max() if (rec >= t).any() else 0.0
                         for t in np.linspace(0, 1, 11)])
            )
        # integral: area under the precision envelope at each new recall point
        ap = 0.0
        prev_r = 0.0
        penv = np.maximum.accumulate(prec[::-1])[::-1]
        for i in range(len(rows)):
            if rows[i][1]:
                ap += penv[i] * (rec[i] - prev_r)
                prev_r = rec[i]
        return float(ap)

    def eval(self) -> float:
        aps = [self._ap(c) for c in range(self.num_classes)]
        aps = [a for a in aps if a is not None]
        return float(np.mean(aps)) if aps else 0.0


class RankAuc(Evaluator):
    """Global pairwise ranking AUC over (score, label[, weight]) samples

    (reference: RankAucEvaluator, Evaluator.cpp:514 — the label-weighted
    Wilcoxon rank statistic). Labels are [0,1] click rates, optionally
    weighted. This is global (not query-grouped); for per-query pairwise
    quality use `PnPair`, which takes query_ids."""

    name = "rank_auc"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._weights: List[np.ndarray] = []

    def update(self, scores, labels, weights=None) -> None:
        s = _host(scores).astype(np.float64).ravel()
        l = _host(labels).astype(np.float64).ravel()
        if ((l < 0) | (l > 1)).any():
            raise ValueError(
                "RankAuc labels must lie in [0, 1] (binary or click-rate "
                f"weights); got range [{l.min()}, {l.max()}]. For graded "
                "relevance labels use PnPair."
            )
        w = (np.ones_like(s) if weights is None
             else _host(weights).astype(np.float64).ravel())
        self._scores.append(s)
        self._labels.append(l)
        self._weights.append(w)

    def eval(self) -> float:
        if not self._scores:
            return 0.0
        s = np.concatenate(self._scores)
        l = np.concatenate(self._labels)
        w = np.concatenate(self._weights)
        order = np.argsort(s, kind="stable")
        s, l, w = s[order], l[order], w[order]
        # weighted Wilcoxon: rank-sum of positives, ties counted half —
        # vectorized by tie group (np.unique on the sorted scores)
        pos_w = l * w
        neg_w = (1.0 - l) * w
        total_pos = pos_w.sum()
        total_neg = neg_w.sum()
        if total_pos == 0 or total_neg == 0:
            return 0.0
        _, inv = np.unique(s, return_inverse=True)
        tp = np.bincount(inv, weights=pos_w)  # per tie-group positive mass
        tn = np.bincount(inv, weights=neg_w)
        neg_below = np.concatenate([[0.0], np.cumsum(tn)[:-1]])
        auc = float(np.sum(tp * (neg_below + tn / 2.0)))
        return auc / (total_pos * total_neg)


class PnPair(Evaluator):
    """Positive/negative pair ratio within queries (reference:

    PnpairEvaluator, Evaluator.cpp:595): for every pair of samples in the
    same query whose labels differ, the pair is positive if the
    higher-labelled sample scored higher, negative if lower; ties count
    half to each. eval() returns pos/neg."""

    name = "pnpair"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # buffer samples and pair in eval(): same-query pairs may span
        # update() calls, and a streaming metric must be batch-size-invariant
        self._rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def update(self, scores, labels, query_ids, weights=None) -> None:
        s = _host(scores).astype(np.float64).ravel()
        l = _host(labels).astype(np.float64).ravel()
        q = _host(query_ids).ravel()
        w = (np.ones_like(s) if weights is None
             else _host(weights).astype(np.float64).ravel())
        self._rows.append((s, l, q, w))

    def eval(self) -> float:
        if not self._rows:
            return float("inf")
        s = np.concatenate([r[0] for r in self._rows])
        l = np.concatenate([r[1] for r in self._rows])
        q = np.concatenate([r[2] for r in self._rows])
        w = np.concatenate([r[3] for r in self._rows])
        pos = neg = 0.0
        for qid in np.unique(q):
            idx = np.nonzero(q == qid)[0]
            ls, ss, ws = l[idx], s[idx], w[idx]
            # vectorized over the query's pair matrix; keep each unordered
            # pair once with the higher-labelled sample as row
            hi = ls[:, None] > ls[None, :]
            pw = (ws[:, None] + ws[None, :]) / 2.0
            s_hi = ss[:, None]
            s_lo = ss[None, :]
            pos += float((pw * (hi & (s_hi > s_lo))).sum())
            neg += float((pw * (hi & (s_hi < s_lo))).sum())
            half = float((pw * (hi & (s_hi == s_lo))).sum()) / 2.0
            pos += half
            neg += half
        return float(pos / neg) if neg else float("inf")


class ValuePrinter(Evaluator):
    """Debug evaluator (reference: ValuePrinter/GradPrinter registrations,

    Evaluator.cpp:1006-1357): records summary stats of every array it is
    fed and prints them at eval()."""

    name = "value_printer"

    def __init__(self, label: str = "value"):
        self.label = label
        self.reset()

    def reset(self) -> None:
        self._stats: List[str] = []

    def update(self, *arrays) -> None:
        for a in arrays:
            a = _host(a)
            if a.size == 0:
                self._stats.append(f"shape={a.shape} empty")
            else:
                self._stats.append(
                    f"shape={a.shape} mean={a.mean():.6g} "
                    f"absmax={np.abs(a).max():.6g}"
                )

    def eval(self) -> str:
        out = "\n".join(f"{self.label}[{i}]: {s}" for i, s in enumerate(self._stats))
        print(out)
        return out
