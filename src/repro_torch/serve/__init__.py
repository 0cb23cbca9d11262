from repro_torch.serve.engine import ServeEngine, build_decode_step, build_prefill_step
from repro_torch.serve.admission import AdmissionController, AdmissionStats, Shed
from repro_torch.serve.tiles import TileGrid, TileRequest, TileServer, zoom_view

__all__ = [
    "build_prefill_step",
    "build_decode_step",
    "ServeEngine",
    "AdmissionController",
    "AdmissionStats",
    "Shed",
    "TileGrid",
    "TileRequest",
    "TileServer",
    "zoom_view",
]
