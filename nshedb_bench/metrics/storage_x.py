"""storage_x: device bytes of the encrypted columns the query reads (each
ciphertext tensor's own elements, a view counted once) over the same
columns' raw bytes at the configuration's `raw_bits` a value.  The
benchmark reads the sizes itself from the device tensors at set-up."""


def read(run):
    raw = run.facts.get("raw_bytes")
    return run.facts["storage_bytes"] / raw if raw else None
