"""peak_gib.train: the caching allocator's peak of allocated device
memory over the window (torch.cuda.max_memory_allocated, reset at the
window's start), in GiB."""


def read(view):
    if view.kind != "train" or view.peak_window_bytes is None:
        return None
    return view.peak_window_bytes / 2 ** 30
