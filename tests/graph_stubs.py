"""A stand-in on the CPU for the port's one CUDA-graph seam,
morpheus_tpu_torch/graphs.py's capture(): stub_capture(monkeypatch, made)
puts in its place a capture that runs the body once, as the warm-up does,
returns the body's output and a StubGraph (appended to `made`), whose
replay runs the body again, with graphs.capturing() reading True, as the
body that a card captured read it."""
from morpheus_tpu_torch import graphs


class StubGraph(graphs.Graph):
    """A "graph" whose replay runs its body eagerly (replays counts
    them)."""

    def __init__(self, body, made: list):
        super().__init__()
        self.body, self.replays = body, 0
        made.append(self)

    def replay(self):
        self.replays += 1
        capturing = graphs.capturing
        graphs.capturing = lambda: True
        try:
            return self.body()
        finally:
            graphs.capturing = capturing


def stub_capture(monkeypatch, made: list) -> None:
    def capture(body, device, generators=()):
        return body(), StubGraph(body, made)
    monkeypatch.setattr(graphs, "capture", capture)
