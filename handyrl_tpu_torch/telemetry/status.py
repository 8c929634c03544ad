"""Read-only learner status endpoint: live JSON over HTTP.

A copy of ``handyrl_tpu.telemetry.status``.

``status_port: <port>`` arms one on the learner; ``curl
http://learner:<port>/`` returns the latest fleet + telemetry + epoch
snapshot — the poll target for dashboards that must not touch the
control plane (the worker protocol stays workers-only; this socket
cannot mutate anything: every method but GET is rejected).

``GET /healthz`` answers a constant tiny JSON (``{"ok": true}``)
WITHOUT invoking the snapshot callable: the liveness probe for load
balancers fronting the serving tier and for the frontend's own
supervision — pollers at high frequency must not pay (or race) the
full snapshot assembly just to learn the process is alive.  A host
fronting a replica POOL passes ``healthz_fn`` (the router's
registry-snapshot answer) and /healthz serves that instead — still
constant-time bookkeeping, still no per-replica dial.

Runs a ThreadingHTTPServer on a daemon thread; the snapshot callable is
invoked per request on the server thread, so it must only read
(`Learner._status_snapshot` assembles from already-thread-safe
sources: the FleetRegistry lock, the last metrics record, telemetry
counters).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class StatusServer:
    """Serve ``snapshot_fn()`` as JSON on every GET."""

    def __init__(self, port, snapshot_fn, healthz_fn=None):
        self.snapshot_fn = snapshot_fn
        self.healthz_fn = healthz_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] == "/healthz":
                    # liveness only: constant body (or the router's
                    # registry-bookkeeping answer) — NEVER the full
                    # snapshot, never a per-replica dial
                    if outer.healthz_fn is None:
                        body = b'{"ok": true}'
                        code = 200
                    else:
                        try:
                            body = json.dumps(outer.healthz_fn()).encode()
                            code = 200
                        except Exception as exc:
                            body = json.dumps(
                                {"ok": False, "error": repr(exc)}).encode()
                            code = 500
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                try:
                    body = json.dumps(outer.snapshot_fn()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                except Exception as exc:  # snapshot raced a teardown
                    body = json.dumps({"error": repr(exc)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet by default
                pass

        self.server = ThreadingHTTPServer(("", int(port)), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self.thread.start()
        print(f"status endpoint on :{self.port}")

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)
