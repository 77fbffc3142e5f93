"""The paper's planning side (copies of ``repro/core/``): the roofline
cost model, the Eq.-3 throughput estimator, placement (Alg. 1 and 2),
the discrete-event simulator and the workload generators."""
