"""Batched CNN split serving on the PyTorch port: a mixed-resolution
request stream.

Submits a stream of single-sample AlexNet requests at two input
resolutions through the port's split-serving engine
(``repro_torch.serving.cnn_engine``): requests bucket per (model,
resolution, dtype, wire) -- each resolution gets its own SmartSplit chain
plan -- pack into batches, and pipeline across requests on the virtual
clock (request i+1's client stage overlaps request i's boundary
transfer).  AlexNet's adaptive average pool makes one parameter set
valid at any resolution, so both buckets share the same weights.

Also demonstrates the two backpressure mechanisms: a deadline tight
enough to expire a queued request, and the bounded queue shedding with
``QueueFullError``.

Run:  PYTHONPATH=src python examples/torch_batch_serving.py [--device cpu]
(the card by default; without one it raises unless ``--device cpu``).
"""
import argparse
import json

import numpy as np

from repro_torch.core.hardware import paper_chain
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_lib
from repro_torch.serving.cnn_engine import CnnServingEngine, QueueFullError


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    layers = cnn_lib.CNN_MODELS["alexnet"]
    params = cnn_lib.init_cnn(layers, in_shape=(3, 64, 64), device=dev)
    eng = CnnServingEngine({"alexnet": params}, hw=paper_chain(3),
                           max_batch=4, max_queue=16, device=dev)

    # ---- mixed-resolution stream ------------------------------------
    rng = np.random.default_rng(0)
    reqs = []
    t = 0.0
    for i in range(12):
        shape = (3, 64, 64) if i % 3 else (3, 96, 96)
        t += float(rng.exponential(0.004))
        x = rng.normal(size=shape).astype(np.float32)
        reqs.append(eng.submit(x, "alexnet", at=t))
    # one request with an impossible deadline: expired, never computed
    tight = eng.submit(rng.normal(size=(3, 64, 64)).astype(np.float32),
                       "alexnet", at=t, deadline_s=1e-6)
    eng.run_until_idle()
    served = sum(r.status == "served" for r in reqs)
    print(f"served {served}/{len(reqs)} mixed-resolution requests; "
          f"tight-deadline request -> {tight.status}")
    assert served == len(reqs)
    assert tight.status == "expired"

    # ---- backpressure ------------------------------------------------
    now = eng.clock.now
    for _ in range(eng.max_queue):
        eng.submit(rng.normal(size=(3, 64, 64)).astype(np.float32),
                   "alexnet", at=now)
    try:
        eng.submit(rng.normal(size=(3, 64, 64)).astype(np.float32),
                   "alexnet", at=now)
        raise AssertionError("queue should have been full")
    except QueueFullError as e:
        print(f"backpressure: {e}")
    eng.run_until_idle()

    # ---- stats -------------------------------------------------------
    s = eng.stats()
    print(f"\nengine stats: served={s['served']} shed={s['shed']} "
          f"expired={s['deadline_expired']} batches={s['batches']} "
          f"(avg size {s['avg_batch_size']:.1f}) "
          f"p50={s['latency_p50_s'] * 1e3:.1f}ms "
          f"p99={s['latency_p99_s'] * 1e3:.1f}ms "
          f"{s['requests_per_s']:.0f} req/s virtual")
    for b in s["buckets"]:
        print(f"  bucket {b['model']}@{tuple(b['in_shape'])} "
              f"{b['dtype']}: cuts={b['cuts']} served={b['served']} "
              f"in {b['batches']} batches")
    print("\nper-hop link accounting:")
    print(json.dumps(s["hops"], indent=1, default=str))
    return s


if __name__ == "__main__":
    main()
