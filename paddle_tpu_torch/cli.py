"""The command line: `python -m paddle_tpu_torch <command> ...`
(paddle_tpu/cli.py, its serving commands).

Commands:
  serve       --model_dir D [--model name=dir ...] [--host H] [--port P]
              [--device cuda|cpu]
              [--max_batch_size N] [--max_wait_ms M] [--max_queue Q]
              [--timeout_ms T] [--seq_len_buckets 64,128,...] [--warmup 0|1]
              [--max_slots S] [--gen_queue Q] [--gen_timeout_ms T]
              [--prefix_cache_mb MB [--prefix_quant int8]]
              [--draft_model D [--draft_k K]]
              [--drain_s S] [--quant int8] [--trace_out PATH]
              [--slo model=interactive|batch ...]
              [--replicas N [--standby K] [--probe_interval_ms P]
               [--autoscale --min_replicas A --max_replicas B
                --cooldown_s C] [--replica_log_dir DIR]]
              [--disaggregate --prefill_replicas N --decode_replicas M
               [--handoff_quant int8]]
              the batching HTTP server over saved inference models
              (paddle_tpu_torch.serving): /predict, /healthz, /stats,
              /metrics, and for generation models /generate (continuous
              batching over S decode slots, NDJSON with "stream": true),
              /prefill and /admit. It runs on the card; `--device cpu`
              asks for the CPU (without a card and without it, serve
              exits non-zero). SIGTERM drains in-flight work for up to
              --drain_s seconds, then exits 0.
              --prefix_cache_mb keeps prefix states on the device (int8
              with --prefix_quant int8); --draft_model decodes
              speculatively with a small draft (the artifact's draft
              sidecar by default), --draft_k tokens a round.
              --quant int8 asserts the artifact is a quantized one.
              --replicas N makes this process a ROUTER over N replica
              serve processes (and --standby warm spares):
              join-shortest-queue, retries of shed requests on another
              replica, breakers, and a dead replica replaced by a
              standby (paddle_tpu_torch.serving.router). Every option
              but the fleet's own goes to the replicas, --device too;
              --replica_log_dir keeps each replica's output in a file.
              --autoscale promotes standbys under pressure and retires
              idle replicas (paddle_tpu_torch.fleetctl.autoscaler).
              --disaggregate splits the fleet into prefill replicas
              (prefix only) and decode replicas (the slot pool):
              /generate runs the prefix on one, ships the boot state as
              a PTHO1 payload (--handoff_quant int8 packs it per row)
              and streams the tokens from the other
              (paddle_tpu_torch.serving.disagg).
  fleetctl    rollout --router URL --model_dir D [--model NAME]
              | status --router URL
              the control-plane client of a serve --replicas router:
              rollout is the zero-downtime version flip (warm the new
              artifact, verify its fingerprint on /healthz, flip, drain
              the old version); status is GET /admin/fleet.
  route       --replica http://host:port [--replica ...] [--host H]
              [--port P] [--probe_interval_ms P] [--request_timeout_ms T]
              a router over replica servers already running.

The JAX package's other commands (train, merge_model, quant, stats, flags,
version) wait for ROADMAP.md A12 and `tune` for A11; `--mesh` for A10b.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

from .serving.engine import _not_ported

__all__ = ["main"]


def _parse_kv(argv, known):
    """--k v / --k=v option parsing (list-valued keys may repeat)."""
    opts: dict = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"unexpected argument {a!r}")
        name, eq, val = a.partition("=")
        name = name[2:].replace("-", "_")
        if name not in known:
            raise SystemExit(f"unknown option --{name}")
        if known[name] is bool:
            # a bare flag: --autoscale (or --autoscale=0)
            opts[name] = val if eq else "1"
            i += 1
            continue
        if not eq:
            if i + 1 >= len(argv):
                raise SystemExit(f"option --{name} requires a value")
            val = argv[i + 1]
            i += 1
        if known[name] is list:
            opts.setdefault(name, []).append(val)
        else:
            opts[name] = val
        i += 1
    return opts


def _model_is_generative(model_dir: str) -> bool:
    """Does the artifact's meta.json carry the generation sidecar? Decides
    whether serve passes the continuous-batching options."""
    try:
        with open(os.path.join(model_dir, "meta.json")) as f:
            return bool(json.load(f).get("generation"))
    except (OSError, ValueError):
        return False


def _on(opts, key) -> bool:
    return opts.get(key, "0") not in ("0", "false", "no", "")


_SERVE_KNOWN = {
    "model_dir": str, "model": list, "host": str, "port": str, "device": str,
    "max_batch_size": str, "max_wait_ms": str, "max_queue": str,
    "timeout_ms": str, "seq_len_buckets": str, "warmup": str,
    "max_slots": str, "gen_queue": str, "gen_timeout_ms": str,
    # the prefix cache and speculative decoding, passed on to every replica
    "prefix_cache_mb": str, "prefix_quant": str, "draft_model": str, "draft_k": str,
    "trace_out": str, "mesh": str, "drain_s": str, "quant": str,
    # per-model SLO classes (model=interactive|batch)
    "slo": list,
    # the fleet (a router and replica processes): not passed on
    "replicas": str, "standby": str, "probe_interval_ms": str, "replica_log_dir": str,
    "autoscale": bool, "min_replicas": str, "max_replicas": str, "cooldown_s": str,
    "disaggregate": bool, "prefill_replicas": str, "decode_replicas": str,
    "handoff_quant": str,
}
_FLEET_ONLY = ("replicas", "standby", "probe_interval_ms", "host", "port", "trace_out",
               "autoscale", "min_replicas", "max_replicas", "cooldown_s", "disaggregate",
               "prefill_replicas", "decode_replicas", "handoff_quant", "replica_log_dir")


def _cmd_serve(argv) -> int:
    """The batching server over saved inference models; with --replicas N
    (or --disaggregate) a router over a replica fleet."""
    from .fleetctl.tenancy import SLOPolicy
    from .serving import BucketPolicy, ModelRegistry, make_server

    opts = _parse_kv(argv, _SERVE_KNOWN)
    if opts.get("mesh"):
        raise _not_ported("a mesh-sharded serving replica (serve --mesh)", "A10b")
    if int(opts.get("replicas", 0) or 0) > 0 or _on(opts, "disaggregate"):
        return _serve_fleet(opts)
    if opts.get("trace_out"):
        from .obs import trace as obs_trace

        obs_trace.arm(out=opts["trace_out"])
        print(f"span tracing armed; Chrome trace JSON will be written to "
              f"{opts['trace_out']} at shutdown", flush=True)
    models = {}
    if "model_dir" in opts:
        models["default"] = opts["model_dir"]
    for spec in opts.get("model", []):
        name, eq, d = spec.partition("=")
        if not eq:
            raise SystemExit(f"--model needs name=dir, got {spec!r}")
        models[name] = d
    if not models:
        raise SystemExit("serve requires --model_dir <dir> or at least one --model name=dir")
    policy = BucketPolicy(
        max_batch_size=int(opts.get("max_batch_size", 64)),
        seq_len_buckets=tuple(int(t) for t in opts.get("seq_len_buckets", "").split(",")
                              if t.strip()))
    # the continuous-batching options, for generation models only
    scheduler_kw = {
        "max_slots": int(opts.get("max_slots", 8)),
        "max_queue": int(opts.get("gen_queue", 64)),
        "timeout_ms": float(opts.get("gen_timeout_ms", 30000.0)),
    }
    # absent unless asked for: the scheduler's defaults (no cache, the
    # artifact's draft sidecar if any) govern
    if opts.get("prefix_cache_mb"):
        scheduler_kw["prefix_cache_mb"] = float(opts["prefix_cache_mb"])
    if opts.get("prefix_quant"):
        scheduler_kw["prefix_cache_quant"] = opts["prefix_quant"]
    if opts.get("draft_model"):
        scheduler_kw["draft_model"] = opts["draft_model"]
    if opts.get("draft_k"):
        scheduler_kw["draft_k"] = int(opts["draft_k"])
    registry = ModelRegistry(slo_policy=SLOPolicy.from_specs(opts.get("slo", [])))
    for name, d in models.items():
        engine, _ = registry.add(
            name, model_dir=d, policy=policy, quantize=opts.get("quant") or None,
            device=opts.get("device") or None,
            max_wait_ms=float(opts.get("max_wait_ms", 5.0)),
            max_queue=int(opts.get("max_queue", 256)),
            timeout_ms=float(opts.get("timeout_ms", 2000.0)),
            scheduler_kw=scheduler_kw if _model_is_generative(d) else None)
        if opts.get("warmup", "1") not in ("0", "false", "no"):
            n = engine.warmup()
            print(f"model {name!r}: warmed {n} bucket programs", flush=True)
        spec = engine.generation_spec()
        if spec is not None:
            print(f"model {name!r}: generation serving on /generate/{name} "
                  f"(beam_size={spec.beam_size} max_len={spec.max_len} "
                  f"slots={scheduler_kw['max_slots']})", flush=True)
    server = make_server(registry, host=opts.get("host", "127.0.0.1"),
                         port=int(opts.get("port", 8866)))
    registry.start()
    # SIGTERM: stop accepting, drain queued and streaming work (bounded by
    # --drain_s), exit 0; a replica being retired never tears a stream
    term = {"signaled": False}

    def _on_term(signum, frame):
        term["signaled"] = True
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (embedded use): the caller owns signals
    print(f"serving {registry.names()} on http://{server.server_address[0]}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        drain_s = float(opts.get("drain_s", 30.0)) if term["signaled"] else 0.0
        if drain_s:
            print(f"SIGTERM: draining in-flight work (up to {drain_s:g}s)", flush=True)
        registry.stop(drain_s=drain_s)
        if drain_s:
            # every result is delivered; give the handler threads a beat to
            # flush their last chunks before the interpreter exits
            time.sleep(0.5)
            print("drained; exiting", flush=True)
        server.server_close()
        from .obs import trace as obs_trace

        if obs_trace.armed():
            tr = obs_trace.disarm(export=True)
            out = getattr(tr, "out", None) if tr is not None else None
            if out:
                print(f"trace written to {out}", flush=True)
    return 0


def _serve_fleet(opts) -> int:
    """serve --replicas N (or --disaggregate): a router and its replica
    fleet."""
    from .fleetctl.tenancy import SLOPolicy
    from .serving.router import Fleet, Router, make_router_server, replica_spawner

    if not opts.get("model_dir") and not opts.get("model"):
        raise SystemExit("serve requires --model_dir <dir> or at least one --model name=dir")
    # the replicas' argv: every option but the fleet's own; they bind port
    # 0 on loopback and print their URL
    child_args = []
    for k, v in opts.items():
        if k in _FLEET_ONLY:
            continue
        if isinstance(v, list):
            child_args.extend(f"--{k}={x}" for x in v)
        else:
            child_args.append(f"--{k}={v}")
    disagg_on = _on(opts, "disaggregate")
    standby = int(opts.get("standby", 0))
    log_dir = opts.get("replica_log_dir") or None
    router = Router(probe_interval_s=float(opts.get("probe_interval_ms", 500)) / 1e3,
                    slo_policy=SLOPolicy.from_specs(opts.get("slo", [])))
    if disagg_on:
        from .serving.disagg import DisaggFleet

        npf = int(opts.get("prefill_replicas", 1))
        ndec = int(opts.get("decode_replicas", 1))
        n = npf + ndec
        fleet = DisaggFleet(replica_spawner(child_args, log_dir=log_dir),
                            prefill_replicas=npf, decode_replicas=ndec, standby=standby,
                            router=router)
    else:
        n = int(opts["replicas"])
        fleet = Fleet(replica_spawner(child_args, log_dir=log_dir), replicas=n,
                      standby=standby, router=router)

    # the rollout hook: model_dir -> a spawn_fn serving THAT artifact with
    # this fleet's options
    def _spawn_template(model_dir):
        args = [a for a in child_args if not a.startswith(("--model_dir=", "--model="))]
        args.append(f"--model_dir={model_dir}")
        return replica_spawner(args, log_dir=log_dir)

    fleet.spawn_template = _spawn_template
    print(f"spawning {n} replica(s)" + (f" + {standby} warm standby" if standby else "")
          + " ...", flush=True)
    fleet.start()
    for r in router.replicas():
        print(f"  replica {r.name}: {r.url}" + (f" [{r.phase}]" if r.phase else ""),
              flush=True)
    scaler = None
    if _on(opts, "autoscale"):
        if disagg_on:
            from .serving.disagg import make_phase_autoscalers

            scaler = make_phase_autoscalers(fleet).start()
            print("phase autoscalers armed: prefill scales on queue age/depth, decode on "
                  "slot occupancy", flush=True)
        else:
            from .fleetctl import Autoscaler, AutoscalerConfig

            cfg = AutoscalerConfig(
                min_replicas=int(opts.get("min_replicas", 1)),
                max_replicas=int(opts.get("max_replicas", max(n, 1) + max(standby, 1))),
                cooldown_s=float(opts.get("cooldown_s", 3.0)))
            scaler = Autoscaler(fleet, cfg).start()
            print(f"autoscaler armed: {cfg.min_replicas}..{cfg.max_replicas} replicas, "
                  f"cooldown {cfg.cooldown_s:g}s", flush=True)
    dispatcher = None
    if disagg_on:
        from .serving.disagg import DisaggDispatcher

        dispatcher = DisaggDispatcher(router, quant=opts.get("handoff_quant") or None)
        print("disaggregated dispatch armed: /generate phase-splits prefill -> handoff -> "
              "decode" + (f" (handoff quant {opts['handoff_quant']})"
                          if opts.get("handoff_quant") else ""), flush=True)
    server = make_router_server(router, host=opts.get("host", "127.0.0.1"),
                                port=int(opts.get("port", 8866)), fleet=fleet,
                                autoscaler=scaler, disagg=dispatcher)
    server.serve_background()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda s, f: stop.set())
        except ValueError:
            pass
    print(f"routing /predict and /generate for {n} replica(s) on "
          f"http://{server.server_address[0]}:{server.port}", flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    print("stopping fleet (graceful: replicas drain in-flight work)", flush=True)
    if scaler is not None:
        scaler.stop()
    server.shutdown()
    fleet.stop(graceful=True)
    server.server_close()
    return 0


def _cmd_fleetctl(argv) -> int:
    """The control-plane client of a fleet router: `rollout` POSTs
    /admin/rollout, `status` GETs /admin/fleet."""
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit("usage: fleetctl rollout --router URL --model_dir D [--model NAME]\n"
                         "       fleetctl status --router URL")
    verb, rest = argv[0], argv[1:]
    known = {"router": str, "model_dir": str, "model": str, "drain_timeout_s": str}
    opts = _parse_kv(rest, known)
    url = (opts.get("router") or "http://127.0.0.1:8866").rstrip("/")
    try:
        if verb == "status":
            with urllib.request.urlopen(url + "/admin/fleet", timeout=10.0) as f:
                payload = json.load(f)
        elif verb == "rollout":
            if not opts.get("model_dir"):
                raise SystemExit("fleetctl rollout requires --model_dir <new artifact dir>")
            body = {"model_dir": opts["model_dir"], "model": opts.get("model", "default")}
            if opts.get("drain_timeout_s"):
                body["drain_timeout_s"] = float(opts["drain_timeout_s"])
            req = urllib.request.Request(url + "/admin/rollout", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            # a rollout blocks through warm, verify, flip and drain: the
            # timeout is a model load's, not a ping's
            with urllib.request.urlopen(req, timeout=600.0) as f:
                payload = json.load(f)
        else:
            raise SystemExit(f"unknown fleetctl verb {verb!r}; try: rollout, status")
    except urllib.error.HTTPError as e:
        try:
            detail = json.load(e).get("error", "")
        except Exception:
            detail = ""
        print(f"fleetctl {verb} failed: HTTP {e.code} {detail}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach router at {url}: {e.reason}", file=sys.stderr)
        return 1
    print(json.dumps(payload, indent=2, sort_keys=True))
    return 0


def _cmd_route(argv) -> int:
    """A router over replicas already running (spawned by `serve` on other
    hosts or ports, or by an outside scheduler)."""
    from .serving.router import Router, make_router_server

    known = {"replica": list, "host": str, "port": str, "probe_interval_ms": str,
             "request_timeout_ms": str}
    opts = _parse_kv(argv, known)
    urls = opts.get("replica", [])
    if not urls:
        raise SystemExit("route requires at least one --replica http://host:port")
    router = Router(replicas=urls,
                    probe_interval_s=float(opts.get("probe_interval_ms", 500)) / 1e3,
                    request_timeout_s=float(opts.get("request_timeout_ms", 120000)) / 1e3)
    server = make_router_server(router, host=opts.get("host", "127.0.0.1"),
                                port=int(opts.get("port", 8866)))
    router.start()
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    except ValueError:
        pass
    threading.Thread(target=lambda: (stop.wait(), server.shutdown()), daemon=True).start()
    print(f"routing {len(urls)} replica(s) on "
          f"http://{server.server_address[0]}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
        server.server_close()
    return 0


_LEFT_OUT = {"train": "A12", "merge_model": "A12", "quant": "A12", "stats": "A12",
             "flags": "A12", "version": "A12", "tune": "A11"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return _cmd_serve(rest)
    if cmd == "route":
        return _cmd_route(rest)
    if cmd == "fleetctl":
        return _cmd_fleetctl(rest)
    if cmd in _LEFT_OUT:
        raise _not_ported(f"the `{cmd}` command", _LEFT_OUT[cmd])
    raise SystemExit(f"unknown command {cmd!r}; try: serve, route, fleetctl")
