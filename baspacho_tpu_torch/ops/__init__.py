from .plan import NumericPlan, build_plan

__all__ = ["NumericPlan", "build_plan"]
