"""The served-walk viewer, in a process of its own (standard library only,
so it shares no interpreter lock with the frame server).

Reads one JSON object on stdin: {"host", "port", "seconds", "events"
(traffic.schedule, ms after the window opens), "points" (shares of the
window, traffic.sample_points)}. It loops as the viewer page does
(serve.py's viewer HTML): GET /frame.png, decode the image, GET /stats,
and again at once; and it posts each event to /input at its time. The window opens at the first frame
received. A delivery is a PNG whose bytes differ from the one received
before it. Prints one JSON line when the window opens ({"window_start"})
and one when it closes: the delivery times (time.perf_counter seconds,
the clock every process of the machine shares), the count of failed
requests, and the PNGs delivered first after each point of the window
(base64).
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import time
import zlib


def _request(host, port, method, path, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _inflate(png: bytes) -> int:
    """The page's image decode: inflate the PNG's pixel data."""
    pos, idat = 8, []
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        if png[pos + 4:pos + 8] == b"IDAT":
            idat.append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    return len(zlib.decompress(b"".join(idat)))


def run(args: dict) -> dict:
    host, port, seconds = args["host"], int(args["port"]), float(args["seconds"])
    deadline = time.perf_counter() + 600.0
    prev = None
    while True:   # the first frame opens the window
        status, body = _request(host, port, "GET", "/frame.png")
        if status == 200:
            prev = body
            break
        if time.perf_counter() > deadline:
            raise RuntimeError("the server served no frame")
        time.sleep(0.01)
    t0 = time.perf_counter()
    print(json.dumps({"window_start": t0}), flush=True)
    t_end = t0 + seconds
    events = [tuple(e) for e in args["events"]]
    points = [t0 + p * seconds for p in args["points"]]
    deliveries, kept, failed, next_event = [], [], 0, 0
    while True:
        now = time.perf_counter()
        while next_event < len(events) and t0 + events[next_event][0] / 1000.0 <= now:
            e = events[next_event]
            msg = ({"type": "mouse", "dx": e[2], "dy": e[3]} if e[1] == "mouse"
                   else {"type": e[1], "code": e[2]})
            status, _ = _request(host, port, "POST", "/input", json.dumps(msg).encode())
            failed += status != 200
            next_event += 1
        if now >= t_end:
            break
        status, body = _request(host, port, "GET", "/frame.png")
        t = time.perf_counter()
        if status != 200:
            failed += 1
            continue
        if body != prev and t <= t_end:
            prev = body
            deliveries.append(t)
            while len(kept) < len(points) and t >= points[len(kept)]:
                kept.append(base64.b64encode(body).decode())
        _inflate(body)
        status, _ = _request(host, port, "GET", "/stats")
        failed += status != 200
    if len(kept) < len(points):   # the window's end: the last delivery
        kept += [base64.b64encode(prev).decode()] * (len(points) - len(kept))
    return {"window_start": t0, "window_end": t_end, "deliveries": deliveries,
            "failed": failed, "kept": kept}


def main() -> int:
    out = run(json.loads(sys.stdin.read()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
