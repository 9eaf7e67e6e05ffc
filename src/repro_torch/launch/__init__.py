"""Launchers of the port: ``serve`` (batched prefill + greedy decode)
and ``train`` (CyclicFL on the pod backend, ``run_pod_training``)."""
