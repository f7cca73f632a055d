"""Quickstart on the PyTorch port: the paper in one minute.

1. Build the per-layer cost profile of AlexNet (the paper's Table-I model).
2. Run SmartSplit (NSGA-II + TOPSIS) on the paper's smartphone environment.
3. Execute the split CNN inference with ``repro_torch`` (the card's conv
   and codec kernels) and verify the boundary payload matches the
   optimiser's I|l1 term and the logits match the monolithic network --
   bit for bit on the follow wire, the same top-1 on a re-encoding one.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default; without one it raises unless ``--device cpu``).
``REPRO_WIRE_DTYPE=int8`` sends the boundary through the int8 codec.
"""
import argparse

import torch

from repro_torch.core import PAPER_ENV_J6, smartsplit
from repro_torch.core.costs import evaluate_objectives
from repro_torch.core.dtype_policy import conv_dtype, resolve_wire_dtype
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.models.profiles import cnn_profile
from repro_torch.runtime import encode_boundary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    name = "alexnet"
    profile = cnn_profile(name)
    print(f"{name}: {profile.num_layers} layers "
          f"(paper counts 21 for AlexNet)")

    # --- the optimiser -----------------------------------------------------
    plan = smartsplit(profile, PAPER_ENV_J6, f3_mode="activations")
    lat, en, mem = plan.objectives
    print(f"SmartSplit split index l1 = {plan.split_index} "
          f"(paper Table I: 3)")
    print(f"  predicted latency {lat:.3f}s  energy {en:.3f}J  "
          f"client memory {mem / 2**20:.2f} MiB")
    print(f"  Pareto set: {sorted(plan.pareto_indices)}")

    # --- the runtime -------------------------------------------------------
    layers = cnn.CNN_MODELS[name]
    params = cnn.init_cnn(layers, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn((1, 3, 224, 224), generator=gen) * 0.1).to(dev)

    with torch.no_grad():
        full_logits = cnn.apply_cnn(layers, params, x)
        split_logits, boundary = cnn.apply_split(layers, params, x,
                                                 plan.split_index)
    wire = resolve_wire_dtype(storage=conv_dtype())
    if wire == conv_dtype():
        # follow/storage wire: the split is bit-for-bit the monolithic run
        assert torch.equal(split_logits, full_logits)
        print("split execution matches monolithic network: OK")
    else:
        # re-encoding wire (e.g. REPRO_WIRE_DTYPE=int8): bounded
        # quantization error, same top-1
        err = float((split_logits - full_logits).abs().max())
        assert torch.equal(split_logits.argmax(-1), full_logits.argmax(-1))
        print(f"split execution matches monolithic top-1 "
              f"({wire} wire, max|dlogit| {err:.1e}): OK")
    # what actually crosses the link, vs the optimiser's I|l1 term
    payload, _ = encode_boundary(boundary, wire)
    sent = len(payload)
    modelled = profile.wire_boundary(wire)[plan.split_index]
    print(f"boundary payload ({wire}): runtime {sent} B "
          f"== model {modelled:.0f} B")
    assert sent == modelled

    # --- the trade-off curve ----------------------------------------------
    F = evaluate_objectives(profile, PAPER_ENV_J6)
    print("\n l1   latency_s  energy_J  memory_MiB")
    for l1 in sorted(set([1, 3, 6, 13, 20])):
        print(f"{l1:3d}   {F[l1, 0]:9.3f} {F[l1, 1]:9.3f} "
              f"{F[l1, 2] / 2**20:11.2f}")
    return {"wire": wire, "split_logits": split_logits,
            "full_logits": full_logits, "sent": sent, "modelled": modelled}


if __name__ == "__main__":
    main()
