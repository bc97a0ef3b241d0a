"""Corpus pipeline time a pass: the benchmark's clock around each pass
(decode_corpus_device + checksum()) less that pass's host scan
(CorpusSummary.scan_s), averaged over the traced passes."""


def read(run):
    passes = run.record.get("passes")
    if not passes:
        return None
    return sum(p["wall_s"] - p["scan_s"] for p in passes) / len(passes) * 1e3
