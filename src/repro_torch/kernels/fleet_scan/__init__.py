"""The fleet_vec cap=1 group recursion over a CSR batch of groups."""
from repro_torch.kernels.fleet_scan.ops import fleet_scan, fleet_scan_plain

__all__ = ["fleet_scan", "fleet_scan_plain"]
