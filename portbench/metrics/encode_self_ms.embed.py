"""What the retriever's forward does outside the vision and LM spans (the
token embedding, the scatter of slice features into the token rows, wmean
and L2): the program's `visrag_ret.forward` span less its children, CUDA
events, ms a batch."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(
        program_spans.self_device_ms(tracer, "visrag_ret.forward"))
