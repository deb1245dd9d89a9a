"""seal_open_ms.train: host milliseconds a step of the window spends
sealing (``core.enclave.ingress("encrypted", ...)``) and opening
(``egress``) every array of its batch, each open ending in its MAC
check's sync; the mean over the window's steps."""


def read(r):
    spans = r.spans.get("seal_open")
    return 1e3 * sum(spans) / len(spans) if spans else None
