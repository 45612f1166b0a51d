"""setup_s: from process start to the first timed unit (imports, kernel
builds or loads, seeded weights, inputs, the warm unit), host clock."""


def read(run):
    return run.setup_s
