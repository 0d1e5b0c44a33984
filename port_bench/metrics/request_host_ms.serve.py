"""Host ms per served request spent in the stream's constructor (tokenize,
text tower, x_T) plus `result_u8()` and the copy of the video to the host:
the benchmark's spans around those calls, synchronized at both ends in the
traced run."""


def read(trace):
    opens = trace.spans.get("port_bench.request_host.open", [])
    closes = trace.spans.get("port_bench.request_host.close", [])
    if not opens or not closes:
        return None
    return sum((b - a) / len(opens) for a, b in opens) / 1e3 + \
        sum((b - a) / len(closes) for a, b in closes) / 1e3
