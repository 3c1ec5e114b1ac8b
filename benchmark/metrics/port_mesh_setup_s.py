"""port_mesh_setup_s: seconds of rank 0's spans idg.mesh.launch (starting
the local world), idg.mesh.shard (taking and sorting the rank's rows, with
its range plan) and idg.mesh.stage (the staging), summed; None where none
of them ran."""

from benchmark import port

SPANS = ("idg.mesh.launch", "idg.mesh.shard", "idg.mesh.stage")


def read(ctx):
    snap = port.snapshot()
    spans = (snap or {}).get("spans", {})
    found = [spans[name]["total_s"] for name in SPANS if name in spans]
    return sum(found) if found else None
