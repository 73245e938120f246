"""ControlPlane — the QMP analogue (paper §IV-B2; mirrors
``repro.core.qmp``).

The paper registers a new QMP command (``device_pause <id> <status>``) in
QEMU's monitor; when executed, the monitor calls the device class's pause
callback. Here: a JSON command bus with registered handlers dispatching
into the SVFFManager, plus an optional Unix-socket server speaking
newline-delimited JSON — so external tooling can drive reconfiguration
exactly like libvirt drives QEMU.

Protocol: request  {"execute": <cmd>, "arguments": {...}}
          response {"return": ...} | {"error": {"class", "desc"}}
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable, Optional

from repro_torch.core.fault import InjectedCrash, crashpoint
from repro_torch.core.manager import SVFFManager
from repro_torch.core.tenant import DevicePausedError


class QMPError(RuntimeError):
    pass


class ControlPlane:
    def __init__(self, manager: SVFFManager):
        self.manager = manager
        self._commands: dict[str, Callable] = {}
        self._register_builtin()
        self._server: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- commands
    def register(self, name: str, fn: Callable):
        self._commands[name] = fn

    def _register_builtin(self):
        m = self.manager

        def device_pause(args):
            tid = args["id"]
            pause = bool(args.get("pause", True))
            tn = m.tenants.get(tid)
            if tn is None:
                raise QMPError(f"no tenant {tid}")
            vf = m.pool.find(tn.vf_id)
            if not vf.pausable:
                raise QMPError(f"{vf.vf_id} does not support pause")
            if pause:
                t = m.pause(tn)
            else:
                t = m.unpause(tn)
            return {"timings": t.phases, "status": tn.status}

        def device_add(args):
            tid = args["id"]
            tn = m.tenants.get(tid)
            if tn is None:
                raise QMPError(f"unknown tenant {tid} (register first)")
            t = m.attach(tn, args.get("vf"))
            return {"timings": t.phases, "vf": tn.vf_id}

        def device_del(args):
            tn = m.tenants.get(args["id"])
            if tn is None:
                raise QMPError(f"no tenant {args['id']}")
            t = m.detach(tn)
            return {"timings": t.phases}

        self.register("device_pause", device_pause)
        self.register("device_add", device_add)
        self.register("device_del", device_del)
        self.register("system-rescan",
                      lambda a: {"devices": m.pool.rescan()})
        self.register("query-vfs", lambda a: m.pool.query())
        self.register("query-status", lambda a: m.query())
        self.register("reconf",
                      lambda a: m.reconf(int(a["num_vfs"]),
                                         use_pause=a.get("use_pause")))
        self.register("query-tenant",
                      lambda a: m.tenants[a["id"]].query())

    def execute(self, request: dict) -> dict:
        cmd = request.get("execute")
        args = request.get("arguments", {}) or {}
        if cmd not in self._commands:
            return {"error": {"class": "CommandNotFound",
                              "desc": f"unknown command {cmd!r}"}}
        try:
            ret = self._commands[cmd](args)
            # crash window: the command ran but the monitor dies before the
            # response leaves — the client sees a timeout; every journaled
            # mutation is already committed, so recovery has nothing to do
            # and an idempotent re-query observes the applied state
            crashpoint("qmp_timeout")
            return {"return": ret}
        except InjectedCrash:
            raise          # chaos: the monitor dies, no error response
        except (QMPError, DevicePausedError, KeyError, RuntimeError) as e:
            return {"error": {"class": type(e).__name__, "desc": str(e)}}

    def execute_json(self, line: str) -> str:
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            return json.dumps({"error": {"class": "JSONParse",
                                         "desc": str(e)}})
        return json.dumps(self.execute(req))

    # ------------------------------------------------------------- socket
    def serve_unix(self, path: str) -> threading.Thread:
        if os.path.exists(path):
            os.remove(path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(4)
        srv.settimeout(0.2)

        def loop():
            greeting = json.dumps(
                {"QMP": {"version": "svff-0.1",
                         "capabilities": ["device_pause"]}})
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                with conn:
                    conn.sendall((greeting + "\n").encode())
                    buf = b""
                    conn.settimeout(2.0)
                    try:
                        while not self._stop.is_set():
                            chunk = conn.recv(65536)
                            if not chunk:
                                break
                            buf += chunk
                            while b"\n" in buf:
                                line, buf = buf.split(b"\n", 1)
                                if line.strip():
                                    resp = self.execute_json(line.decode())
                                    conn.sendall((resp + "\n").encode())
                    except socket.timeout:
                        pass
            srv.close()

        self._server = threading.Thread(target=loop, daemon=True)
        self._server.start()
        return self._server

    def shutdown(self):
        self._stop.set()
        if self._server:
            self._server.join(timeout=3)
