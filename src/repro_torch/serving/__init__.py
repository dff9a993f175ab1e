from repro_torch.serving.engine import Request, ServingEngine, SlotsFull

__all__ = ["Request", "ServingEngine", "SlotsFull"]
