from dnnpde_tpu_torch.serve.export import ServedSolution, load_solution, save_solution

__all__ = ["ServedSolution", "load_solution", "save_solution"]
