"""launch_ms [ms/req], layer dispatch: the self time of the program's
``device_pack`` spans (``CudaEngine._device_pack`` / ``_lz4_device_pack``)
less the ``upload``, ``hist_wait`` and ``dyn_plan`` spans opened
directly in them: the host time that issues the device's work, torch's
op dispatch and the hand kernels' launches. Summed over a
``MeshEngine``'s shares, per program ``compress`` span."""

from qzbench import program_spans

CHILDREN = ("upload", "hist_wait", "dyn_plan")


def read(run):
    spans = program_spans.window(run)
    n = program_spans.requests(spans) if spans else 0
    packs = {s.id for s in spans or () if s.name == "device_pack"}
    if not n or not packs:
        return None
    self_s = (program_spans.seconds(spans, ("device_pack",))
              - program_spans.seconds(spans, CHILDREN, parents=packs))
    return self_s / n * 1e3
