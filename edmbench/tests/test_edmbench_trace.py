"""The trace reduction on a hand-made profile: busy time as a union, launch
calls, the convolutions' device time by their launch calls, idle gaps
labelled by the host's outermost operator."""

from __future__ import annotations

from edmbench.trace import Event, extract, group_of


def _profile() -> list[Event]:
    ev = lambda name, kind, s, e, corr=0, linked=0, thread=1: Event(name, kind, s, e, thread, corr, linked)  # noqa: E731
    return [
        ev("edmbench.window", "span", 0, 100),
        ev("edmbench.train_step", "span", 0, 100),
        ev("aten::convolution", "op", 10, 30, corr=1),
        ev("aten::cudnn_convolution", "op", 11, 29, corr=2),
        ev("cudaLaunchKernel", "runtime", 12, 14, corr=900),
        ev("cudaLaunchKernel", "runtime", 15, 17, corr=901),
        ev("aten::mul", "op", 40, 50, corr=3),
        ev("cudaLaunchKernel", "runtime", 41, 43, corr=902),
        ev("sm90_xmma_fprop_implicit_gemm_bf16", "device", 20, 35, corr=900, linked=2),
        ev("void cudnn::nchwToNhwcKernel", "device", 30, 40, corr=901, linked=2),
        ev("void at::vectorized_elementwise_kernel", "device", 45, 55, corr=902, linked=3),
        ev("void at::vectorized_elementwise_kernel", "device", 90, 95, corr=903),
    ]


def test_extract_reads_busy_launches_convolutions_and_gaps():
    t = extract(_profile(), ops=True)
    assert t.window_us == 100
    assert t.busy_us == (40 - 20) + (55 - 45) + (95 - 90)  # overlapping kernels counted once
    assert t.launches == 3
    assert t.conv_us == 15 + 10  # the kernel and the layout transform under the convolution
    # each gap under the operator around its middle, else between operators
    assert t.gaps == {"train_step: aten::convolution": 20, "train_step: aten::mul": 5,
                      "train_step: between ops": 35 + 5}


def test_device_only_stretch_runs_from_first_to_last_event():
    events = [e for e in _profile() if e.kind in ("device", "runtime")]
    t = extract(events, ops=False)
    assert t.window_us == 95 - 12 and t.conv_us is None and t.launches == 3


def test_layout_transforms_are_not_convolutions():
    assert group_of("void cudnn::nchwToNhwcKernel<__nv_bfloat16>") == "layout transforms (cuDNN)"
    assert group_of("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "conv (cuDNN)"
