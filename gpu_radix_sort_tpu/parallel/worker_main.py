"""Worker process entry: sort-round events over stdin.

Reference analog: faasTest/f.py's ``directInvoke`` mode (f.py:147-182) —
read an event JSON from stdin, mount the shared file-array root from the
environment, run the handler, answer ``{"success": bool, "err": str}`` on
stdout.  Optional per-invocation cProfile dumps (reference: f.py:24-36
writes faas*.csv/.prof per step) are enabled by GRS_PROFILE_DIR.

Two modes:
  * one-shot (default): whole stdin is one event JSON; one response; exit.
    This is the reference's spawn-per-invocation model.
  * ``--serve``: line-delimited JSON events until EOF, one response line
    per event.  Used by :class:`parallel.serverless.WorkerPool` — a served
    worker keeps its process (and its jit compilation cache) alive across
    rounds, which the reference's FaaS model pays for on every invocation.

Run as ``python -m gpu_radix_sort_tpu.parallel.worker_main [--serve]``.
"""

from __future__ import annotations

import json
import os
import sys

from .serverless import MOUNT_ENV


def _handle(event: dict, mount: str, profile_dir: str | None) -> dict:
    profiler = None
    if profile_dir:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()

    try:
        from ..data.file import FileArrayFactory
        from .serverless import handle_event

        handle_event(event, FileArrayFactory(mount))
        response = {"success": True, "err": ""}
    except Exception as e:  # noqa: BLE001 - worker boundary reports all errors
        response = {"success": False, "err": f"{type(e).__name__}: {e}"}

    if profiler is not None:
        profiler.disable()
        os.makedirs(profile_dir, exist_ok=True)
        tag = f"worker_{event.get('output', 'unknown')}_{os.getpid()}"
        profiler.dump_stats(os.path.join(profile_dir, f"{tag}.prof"))
        import io
        import pstats

        buf = io.StringIO()
        pstats.Stats(profiler, stream=buf).sort_stats("cumulative").print_stats(30)
        with open(os.path.join(profile_dir, f"{tag}.txt"), "w") as f:
            f.write(buf.getvalue())
    return response


def main() -> int:
    serve = "--serve" in sys.argv[1:]
    mount = os.environ.get(MOUNT_ENV)
    # Errors are in-band ({success: false} on stdout, exit 0) for EVERY
    # validation path: invoke_subprocess only surfaces stderr on a nonzero
    # exit, so exiting 1 after printing JSON would discard the message.
    if not mount:
        print(json.dumps({"success": False, "err": f"{MOUNT_ENV} not set"}),
              flush=True)
        return 0
    profile_dir = os.environ.get("GRS_PROFILE_DIR")

    if not serve:
        try:
            event = json.load(sys.stdin)
        except json.JSONDecodeError as e:
            print(json.dumps({"success": False, "err": f"bad event JSON: {e}"}))
            return 0
        print(json.dumps(_handle(event, mount, profile_dir)))
        return 0  # handler errors are in-band; nonzero = process failure

    # --serve: one JSON event per line until EOF.
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"success": False, "err": f"bad event JSON: {e}"}),
                  flush=True)
            continue
        print(json.dumps(_handle(event, mount, profile_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
