"""Kernel-launch calls the host made to the CUDA runtime or driver in the
traced window (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``
and their kin; ``tracing.LAUNCH_CALLS``) per image: a graph that replays
many kernels counts once."""


def read(run):
    t, win = run["trace"], run["window"]
    if t is None or not t.launch_calls or not win["images"]:
        return None
    return t.launch_calls / win["images"]
