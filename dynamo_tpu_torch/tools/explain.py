"""Why did my request do that? A terminal reader of the decision
provenance plane.

The port's own copy of the reference's tools/explain.py (stdlib only): it
fetches a request's cross-process decision timeline from a frontend's
``GET /debug/decisions/{request_id}`` (this process's records and those the
workers and the router shipped) and prints it in causal order: who decided
what, over which alternatives, and why. With ``--fleet`` it prints the
``GET /debug/fleet`` snapshot instead: admission, the brownout rung, the
decision counts and the recent fleet-scoped decisions (health ejections,
brownout steps) by actor.

    python -m dynamo_tpu_torch.tools.explain chatcmpl-abc123
    python -m dynamo_tpu_torch.tools.explain chatcmpl-abc123 --json
    python -m dynamo_tpu_torch.tools.explain --fleet --base http://frontend:8080

Needs ``DYN_DECISIONS=1`` (the default) on the serving processes; raise
``DYN_DECISIONS_RING`` when old requests have been evicted.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def _get(url: str, timeout: float) -> dict:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read().decode())
            msg = detail.get("error", {}).get("message", str(e))
        except Exception:  # noqa: BLE001 — best-effort error body
            msg = str(e)
        raise SystemExit(f"error: {url}: {msg}") from e
    except OSError as e:
        raise SystemExit(f"error: cannot reach {url}: {e}") from e


def _fmt_attrs(d: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(d.items()))


def render_timeline(body: dict) -> str:
    """One line per decision, sorted causally by the server, with the
    wall-clock offset from the first record as the left gutter."""
    recs = body.get("decisions") or []
    lines = []
    rid = body.get("request_id", "?")
    if body.get("partial"):
        lines.append(
            f"request {rid}: PARTIAL — worker records not yet ingested "
            "(retry, or raise DYN_TRACE_ASSEMBLE_MS)"
        )
    else:
        procs = ", ".join(body.get("procs") or [])
        lines.append(
            f"request {rid}: {len(recs)} decisions across [{procs}]"
        )
    t0 = recs[0]["unix_ns"] if recs else 0
    for r in recs:
        off_ms = (r["unix_ns"] - t0) / 1e6
        head = (
            f"  +{off_ms:9.3f}ms  {r['proc']:<12} "
            f"{r['actor']}/{r['kind']:<10}"
        )
        chosen = r.get("chosen")
        body_s = f" -> {chosen}" if chosen is not None else ""
        reason = r.get("reason") or ""
        if reason:
            body_s += f"  [{reason}]"
        attrs = r.get("attrs") or {}
        if attrs:
            body_s += f"  {_fmt_attrs(attrs)}"
        lines.append(head + body_s)
        for alt in r.get("alternatives") or []:
            lines.append(f"{'':>14}      not chosen: {_fmt_attrs(alt)}")
    return "\n".join(lines)


def render_fleet(body: dict) -> str:
    """Compact fleet snapshot: the headline state, the decision counters,
    then recent fleet-scoped decisions grouped by actor."""
    lines = ["fleet snapshot"]
    adm = body.get("admission") or {}
    lines.append(f"  models:    {', '.join(body.get('models') or []) or '-'}")
    lines.append(
        f"  admission: inflight={adm.get('inflight')} "
        f"shed_total={adm.get('shed_total')} "
        f"shed_by_class={adm.get('shed_by_class')}"
    )
    br = body.get("brownout") or {}
    lines.append(
        f"  brownout:  level={br.get('level')} ({br.get('rung')}) "
        f"slo_local={((body.get('slo') or {}).get('local'))} "
        f"slo_remote={((body.get('slo') or {}).get('remote'))}"
    )
    for label in ("health", "planner", "upgrade"):
        if label in body:
            lines.append(f"  {label + ':':<10} {json.dumps(body[label])}")
    dec = body.get("decisions") or {}
    lines.append(
        f"  decisions: enabled={dec.get('enabled')} "
        f"ring_dropped={dec.get('ring_dropped')}"
    )
    for key, n in sorted((dec.get("counts") or {}).items()):
        lines.append(f"      {key:<24} {n}")
    recent = dec.get("fleet_recent") or {}
    if recent:
        lines.append("  recent fleet-scoped decisions:")
    for actor in sorted(recent):
        for r in recent[actor]:
            chosen = r.get("chosen")
            lines.append(
                f"    {actor}/{r.get('kind'):<8} "
                f"{'-> ' + str(chosen) if chosen is not None else ''}"
                f"  [{r.get('reason')}]  epoch={r.get('epoch')}"
                + (f"  {_fmt_attrs(r['attrs'])}" if r.get("attrs") else "")
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("request_id", nargs="?",
                    help="request id to explain (X-Request-Id / "
                    "completion id)")
    ap.add_argument("--fleet", action="store_true",
                    help="render the merged /debug/fleet snapshot instead")
    ap.add_argument("--base", default="http://127.0.0.1:8080",
                    help="frontend base URL (default %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw JSON body instead of rendering")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not args.fleet and not args.request_id:
        ap.error("need a request_id (or --fleet)")

    base = args.base.rstrip("/")
    if args.fleet:
        body = _get(f"{base}/debug/fleet", args.timeout)
        print(json.dumps(body, indent=2) if args.json else render_fleet(body))
        return 0
    body = _get(f"{base}/debug/decisions/{args.request_id}", args.timeout)
    print(json.dumps(body, indent=2) if args.json else render_timeline(body))
    return 0


if __name__ == "__main__":
    sys.exit(main())
