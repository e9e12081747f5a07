"""``ia.build.*`` spans per traced call: the misses of the port's cached
host functions (tables, plans, uploads), each of which builds or uploads
again."""

from perfbench.harness.spans import BUILD, program_spans


def value(rec: dict) -> float | None:
    spans = program_spans(rec.get("host") or [])
    if not spans:
        return None
    return sum(r.name.startswith(BUILD) for r in spans) / rec["trace_calls"]
