from repro_torch.serving.engine import Request, ServingEngine, SlotsFull
from repro_torch.serving.paged import PagedServingEngine
from repro_torch.serving.pages import PagesExhausted, PageTable
from repro_torch.serving.speculative import (
    expected_committed_tokens,
    make_self_draft,
    spec_exact_reason,
    spec_gain,
)

__all__ = ["PagedServingEngine", "PageTable", "PagesExhausted", "Request",
           "ServingEngine", "SlotsFull", "expected_committed_tokens",
           "make_self_draft", "spec_exact_reason", "spec_gain"]
