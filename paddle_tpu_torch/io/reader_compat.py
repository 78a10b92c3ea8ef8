"""``batch``, the counterpart of ``paddle_tpu/io/reader_compat.py``:
paddle's pre-2.0 generator readers grouped into lists of
``batch_size`` items (the last, shorter one kept unless ``drop_last``).
Exported as ``paddle_tpu_torch.batch``, as the JAX package exports
``paddle_tpu.batch``."""


def batch(reader, batch_size, drop_last=False):
    """A reader (a callable returning an iterator) of lists of
    ``batch_size`` items of ``reader()``."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched
