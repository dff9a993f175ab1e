from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor

__all__ = ["PreemptionHandler", "StragglerMonitor"]
