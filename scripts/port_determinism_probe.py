"""Which operations of the port's bundle adjustment give other bits when
run again on the same inputs, on the card.

    python scripts/port_determinism_probe.py

At the global BA's shapes of chip_smoke.py path 6 (64 keyframes, 16384
points, 1000 features a keyframe), each operation runs 6 times on the same
inputs made from seed 0; prints whether the results are equal bit for bit
and their largest difference: the Schur product, the batched einsums, the
dense solve, the sum over keyframes, and index_add_ with unique indices,
with unique indices and one discarded sink row, and with duplicates (also
with deterministic algorithms on, then captured in a CUDA graph, replayed
and run under sync debug mode "error").
"""

import sys

import torch


def repeat(name, fn, n=6):
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    diff = max(float((outs[0] - o).abs().max()) for o in outs[1:])
    print(f"{name}: bitwise over {n} runs {same}, max difference {diff:.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.manual_seed(0)
    dev, K, P, N = "cuda", 64, 16384, 1000
    print(torch.cuda.get_device_name(0), flush=True)
    Ar = torch.randn(K * 6, P * 3, device=dev)
    Br = torch.randn(K * 6, P * 3, device=dev)
    repeat("GEMM [384 x 49152] @ [49152 x 384]", lambda: Br @ Ar.T)
    A = torch.randn(K, P, 6, 3, device=dev)
    Hinv = torch.randn(P, 3, 3, device=dev)
    repeat("einsum kpai,pij->kapj", lambda: torch.einsum("kpai,pij->kapj", A, Hinv))
    S = torch.randn(K * 6, K * 6, device=dev)
    S = S @ S.T + torch.eye(K * 6, device=dev)
    rhs = torch.randn(K * 6, device=dev)
    repeat("solve_ex [384]", lambda: torch.linalg.solve_ex(S, rhs)[0])
    J = torch.randn(K, N, 3, 6, device=dev)
    repeat("einsum knia,knib->kab", lambda: torch.einsum("knia,knib->kab", J, J))
    vals = torch.randn(K * N, 30, device=dev)
    rows = K * (P + 1)
    dup = torch.randint(0, rows, (K * N,), device=dev)
    repeat("index_add_ with duplicates",
           lambda: torch.zeros(rows, 30, device=dev).index_add_(0, dup, vals))
    uniq = torch.randperm(rows, device=dev)[:K * N]
    repeat("index_add_ with unique indices",
           lambda: torch.zeros(rows, 30, device=dev).index_add_(0, uniq, vals))
    sink = torch.where(torch.rand(K * N, device=dev) < 0.5, uniq, rows - 1)
    repeat("index_add_ with unique indices and one discarded sink row",
           lambda: torch.zeros(rows, 30, device=dev).index_add_(0, sink, vals)[:-1])
    g = torch.randn(K, P + 1, 30, device=dev)
    repeat("sum over the keyframe axis", lambda: g.sum(0))

    # index_add_ with duplicates through the deterministic (sort-based)
    # kernel: repeated, captured in a CUDA graph and replayed, and watched
    # for host syncs
    def deterministic_add():
        torch.use_deterministic_algorithms(True)
        try:
            return torch.zeros(rows, 30, device=dev).index_add_(0, dup, vals)
        finally:
            torch.use_deterministic_algorithms(False)

    repeat("index_add_ with duplicates, deterministic algorithms on", deterministic_add)
    want = deterministic_add()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        deterministic_add()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = deterministic_add()
    graph.replay()
    torch.cuda.synchronize()
    print(f"captured and replayed: equal to the eager call {torch.equal(out, want)}", flush=True)
    for label, fn in (("plain", lambda: torch.zeros(rows, 30, device=dev).index_add_(0, dup, vals)),
                      ("deterministic", deterministic_add)):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(f"index_add_ with duplicates, {label}: {start.elapsed_time(end) / 20:.3f} ms a call "
              f"(CUDA events, {K * N} rows of 30 into {rows}, the zero fill included)", flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        deterministic_add()
        graph.replay()
        print("no host sync in the call or the replay", flush=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
