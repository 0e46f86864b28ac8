"""The readers of the program's own spans (``upload_ms``, ``idle_wait_ms``,
``host_waits``, ``stem_fwd_ms``, ``augment_span_ms``) on hand-built
traces in ``common.reduce_profile``'s form: times in us, two steps."""

import pytest

from port_bench import run

READERS = ("upload_ms", "idle_wait_ms", "host_waits", "stem_fwd_ms",
           "augment_span_ms")
HTOD = "Memcpy HtoD (Pinned -> Device)"


def trace(spans, ops=(), device=(), steps=2):
    return {"spans": spans, "ops": list(ops), "device": list(device),
            "steps": steps, "window_s": 1e-3}


def read(name, tr):
    return run.load_metric(name).read(tr)


def parent_spans():
    """What the parent commit's program records: the benchmark's spans and
    the step's three ranges, none of the readers' spans."""
    return {"loader.next": [(0, 10)], "driver.step": [(10, 400)],
            "step.forward_loss": [(100, 200)], "step.backward": [(200, 300)],
            "step.optimizer": [(300, 350)],
            "cudaStreamSynchronize": [(20, 30)]}


def test_upload_counts_only_copies_launched_in_an_upload_span():
    device = [(HTOD, 100, 1100), (HTOD, 1200, 1700), (HTOD, 1800, 2100),
              (HTOD, 2200, 6200), ("elementwise_kernel", 6300, 7200),
              ("Memcpy DtoH (Device -> Pinned)", 7300, 7370)]
    tr = trace({"batch.upload": [(10, 20), (40, 50)],
                "embed.upload": [(60, 70)], "step.backward": [(100, 200)]},
               ops=[(12, [(HTOD, 1000.0)]),
                    (14, [(HTOD, 1000.0)]),  # the same copy, linked twice
                    (45, [(HTOD, 500.0), ("elementwise_kernel", 900.0)]),
                    (65, [(HTOD, 300.0)]),
                    (150, [(HTOD, 4000.0)]),  # outside any upload span
                    (15, [("Memcpy DtoH (Device -> Pinned)", 70.0)])],
               device=device)
    assert read("upload_ms", tr) == pytest.approx((1000 + 500 + 300) / 1e3
                                                  / 2)
    assert read("upload_ms.slowfast", tr) == read("upload_ms.embed", tr) \
        == read("upload_ms", tr)


def test_idle_wait_charges_gaps_by_the_span_they_open_in():
    spans = {"batch.upload": [(0, 50)], "step.backward": [(100, 200)],
             "metrics.drain": [(300, 320)]}
    device = [("a", 0, 40), ("b", 60, 110),  # gap 40-60 opens in the upload
              ("c", 150, 160),  # gap 110-150 opens in the backward
              ("d", 170, 305),  # gap 160-170 in the backward too
              ("e", 330, 340)]  # gap 305-330 opens in the drain
    tr = trace(spans, device=device)
    assert read("idle_wait_ms", tr) == pytest.approx((20 + 25) / 1e3 / 2)


def test_host_waits_counts_synchronisations_inside_program_spans():
    spans = {"batch.upload": [(0, 50)], "step.forward_loss": [(100, 200)],
             "metrics.drain": [(300, 400)],
             "cudaStreamSynchronize": [(10, 40), (310, 320), (330, 340),
                                       (250, 260),  # in no program span
                                       (390, 410)],  # leaves the drain
             "cudaDeviceSynchronize": [(150, 160)],
             "cudaEventSynchronize": [(500, 510)],
             "cudaMemcpyAsync": [(5, 9)]}
    tr = trace(spans, device=[("k", 0, 1)])
    assert read("host_waits", tr) == 4 / 2
    assert read("host_waits.embed", tr) == read("host_waits", tr)


@pytest.mark.parametrize("name,span", [("stem_fwd_ms", "model.stem"),
                                       ("augment_span_ms", "batch.augment")])
def test_kernels_launched_in_the_span(name, span):
    tr = trace({span: [(100, 200)], "step.backward": [(300, 400)]},
               ops=[(110, [("fprop", 4000.0), (HTOD, 100.0)]),
                    (190, [("relu", 200.0)]),
                    (350, [("wgrad", 3000.0)])],
               device=[("k", 0, 1)])
    assert read(name, tr) == pytest.approx(4.2 / 2)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_spans(name):
    """The parent commit's program has none of these spans: every reader
    returns None, and raises nothing."""
    tr = trace(parent_spans(),
               ops=[(15, [(HTOD, 1000.0)]), (150, [("fprop", 10.0)])],
               device=[("a", 0, 40), ("b", 60, 110)])
    assert read(name, tr) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_device_work(name):
    """A run on the CPU: the spans are there, the device timeline is not."""
    spans = {n: [(0, 10)] for n in (
        "batch.upload", "batch.augment", "metrics.drain", "model.stem",
        "embed.upload", "embed.readback")}
    assert read(name, trace(spans)) is None
