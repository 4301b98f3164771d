"""The port's runtime environments held against the JAX package's.

One driver script runs in a subprocess under each package (`ray_tpu` and
`ray_tpu_torch`) through the same public API, the cases of
tests/test_runtime_env.py: env_vars per task, working_dir, py_modules, an
actor's env, a job-level env from init(), a bad env failing fast, a new
env when the worker pool is full, a submitted job's env inherited by its
tasks, a job's working_dir, pip from a local sdist (`--no-index`), conda
rejected, and a custom plugin. Each side prints one `RESULT` line; each
case must give the same outcome under both, and the outcome the JAX test
asserts. The validation cases run in this process against both classes.
"""

import pytest

from tests.test_torch_serve_api import PRELUDE, run_driver

DRIVER = PRELUDE + r'''
import tempfile

renv_mod = importlib.import_module(pkg + ".runtime_env.runtime_env")
worker_mod = importlib.import_module(pkg + "._private.worker")
config_mod = importlib.import_module(pkg + "._private.config")
JobSubmissionClient = importlib.import_module(pkg + ".job").JobSubmissionClient
tmp = tempfile.mkdtemp(prefix="renv_" + pkg + "_")


def case(out, name, fn):
    try:
        out[name] = fn()
    except Exception as e:  # noqa: BLE001 — recorded, compared by the test
        out[name] = ["raised", type(e).__name__, str(e)[:300]]


def env_vars_per_task():
    @rt.remote
    def read_env(name):
        return os.environ.get(name)

    before = rt.get(read_env.remote("RT_TEST_FLAG"))
    got = rt.get(read_env.options(
        runtime_env={"env_vars": {"RT_TEST_FLAG": "on"}}
    ).remote("RT_TEST_FLAG"))
    after = rt.get(read_env.remote("RT_TEST_FLAG"))
    return [before, got, after]


def working_dir():
    pkg_dir = os.path.join(tmp, "proj")
    os.makedirs(pkg_dir)
    with open(os.path.join(pkg_dir, "shipped_mod.py"), "w") as f:
        f.write("MAGIC = 'shipped-42'\n")
    with open(os.path.join(pkg_dir, "data.txt"), "w") as f:
        f.write("payload\n")

    @rt.remote(runtime_env={"working_dir": pkg_dir})
    def use_shipped():
        import shipped_mod

        with open("data.txt") as f:
            data = f.read().strip()
        return [shipped_mod.MAGIC, data,
                os.path.basename(os.getcwd()) != "proj"]

    return rt.get(use_shipped.remote(), timeout=60)


def py_modules():
    mod_dir = os.path.join(tmp, "libs")
    os.makedirs(mod_dir)
    with open(os.path.join(mod_dir, "extra_lib.py"), "w") as f:
        f.write("def f():\n    return 99\n")

    @rt.remote(runtime_env={"py_modules": [mod_dir]})
    def use_lib():
        import extra_lib

        return extra_lib.f()

    return rt.get(use_lib.remote(), timeout=60)


def actor_env():
    @rt.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class EnvActor:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    a = EnvActor.remote()
    return rt.get(a.read.remote(), timeout=60)


def bad_env_fails_fast():
    @rt.remote(max_retries=0)
    def never_runs():
        return 1

    try:
        rt.get(never_runs.options(
            runtime_env={"working_dir": "gcs://_rt_pkg_bogus.zip"}
        ).remote(), timeout=60)
        return "ran"
    except exc.TaskError as e:
        return ["TaskError", "runtime_env" in str(e)]


def new_env_when_pool_is_full():
    @rt.remote
    def plain():
        return os.getpid()

    rt.get([plain.remote() for _ in range(4)])

    @rt.remote
    def with_env():
        return os.environ.get("POOLTEST")

    cfg = config_mod.get_config()
    old = cfg.max_workers_per_node
    cfg.max_workers_per_node = len(worker_mod._global_node.raylet.workers)
    try:
        return rt.get(with_env.options(
            runtime_env={"env_vars": {"POOLTEST": "yes"}}).remote(),
            timeout=60)
    finally:
        cfg.max_workers_per_node = old


def job_env_inherited():
    proj = os.path.join(tmp, "inheritproj")
    os.makedirs(proj)
    with open(os.path.join(proj, "helper_mod.py"), "w") as f:
        f.write("TOKEN = 'inherited-7'\n")
    with open(os.path.join(proj, "driver.py"), "w") as f:
        f.write(
            f"import {pkg} as rt\n"
            "import os\n"
            "rt.init(address=os.environ['RT_GCS_ADDR'])\n"
            "@rt.remote\n"
            "def task():\n"
            "    import helper_mod\n"
            "    return helper_mod.TOKEN\n"
            "print('task got', rt.get(task.remote(), timeout=60))\n"
            "rt.shutdown()\n")
    client = JobSubmissionClient(worker_mod._global_node.gcs_address)
    try:
        sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                                runtime_env={"working_dir": proj})
        state = client.wait_until_finished(sid, timeout=120)
        return [state, "task got inherited-7" in client.get_job_logs(sid)]
    finally:
        client.close()


def job_working_dir():
    proj = os.path.join(tmp, "jobproj")
    os.makedirs(proj)
    with open(os.path.join(proj, "main.py"), "w") as f:
        f.write("print('job saw', open('marker.txt').read().strip())\n")
    with open(os.path.join(proj, "marker.txt"), "w") as f:
        f.write("m4rk3r\n")
    client = JobSubmissionClient(worker_mod._global_node.gcs_address)
    try:
        sid = client.submit_job(
            entrypoint=f"{sys.executable} main.py",
            runtime_env={"working_dir": proj, "env_vars": {"IGNORED": "1"}})
        state = client.wait_until_finished(sid, timeout=60)
        return [state, "job saw m4rk3r" in client.get_job_logs(sid)]
    finally:
        client.close()


def pip_from_local_sdist():
    src = os.path.join(tmp, "rt_pip_dep")
    os.makedirs(os.path.join(src, "rt_pip_dep"))
    with open(os.path.join(src, "rt_pip_dep", "__init__.py"), "w") as f:
        f.write("MAGIC = 'from-venv'\n")
    with open(os.path.join(src, "pyproject.toml"), "w") as f:
        f.write('[build-system]\n'
                'requires = ["setuptools"]\n'
                'build-backend = "setuptools.build_meta"\n'
                '[project]\n'
                'name = "rt-pip-dep"\n'
                'version = "0.0.1"\n'
                '[tool.setuptools.packages.find]\n'
                'include = ["rt_pip_dep"]\n')
    try:
        import rt_pip_dep  # noqa: F401
        return "the driver has the package"
    except ImportError:
        pass

    @rt.remote(runtime_env={"pip": ["--no-index", "--no-build-isolation",
                                    src]}, max_retries=0)
    def use_dep():
        import rt_pip_dep

        return rt_pip_dep.MAGIC

    return rt.get(use_dep.remote(), timeout=300)


def custom_plugin():
    moddir = os.path.join(tmp, "plugmod")
    os.makedirs(moddir)
    open(os.path.join(moddir, "__init__.py"), "w").close()
    with open(os.path.join(moddir, "marker.py"), "w") as f:
        f.write(
            "import os\n"
            f"from {pkg}.runtime_env.runtime_env import RuntimeEnvPlugin\n"
            "class MarkerPlugin(RuntimeEnvPlugin):\n"
            "    name = 'marker'\n"
            "    def prepare(self, value, client):\n"
            "        return value.upper()\n"
            "    def apply(self, value, client):\n"
            "        os.environ['RT_MARKER'] = value\n")
    sys.path.insert(0, tmp)
    try:
        from plugmod.marker import MarkerPlugin

        renv_mod.register_plugin(MarkerPlugin())
        try:
            @rt.remote
            def read_marker():
                return os.environ.get("RT_MARKER")

            return rt.get(read_marker.options(runtime_env={
                "py_modules": [tmp], "marker": "hello"}).remote(),
                timeout=120)
        finally:
            renv_mod._plugins.pop("marker", None)
    finally:
        sys.path.remove(tmp)


def job_level_env():
    @rt.remote
    def read():
        return os.environ.get("JOB_WIDE")

    return rt.get(read.remote(), timeout=60)


out = {}
rt.init(num_cpus=4)
try:
    for name, fn in [("env_vars_per_task", env_vars_per_task),
                     ("working_dir", working_dir),
                     ("py_modules", py_modules),
                     ("actor_env", actor_env),
                     ("bad_env_fails_fast", bad_env_fails_fast),
                     ("new_env_when_pool_is_full", new_env_when_pool_is_full),
                     ("job_env_inherited", job_env_inherited),
                     ("job_working_dir", job_working_dir),
                     ("pip_from_local_sdist", pip_from_local_sdist),
                     ("custom_plugin", custom_plugin)]:
        case(out, name, fn)
finally:
    rt.shutdown()
rt.init(num_cpus=2, runtime_env={"env_vars": {"JOB_WIDE": "set"}})
try:
    case(out, "job_level_env", job_level_env)
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''

EXPECTED = {
    "env_vars_per_task": [None, "on", None],
    "working_dir": ["shipped-42", "payload", True],
    "py_modules": 99,
    "actor_env": "yes",
    "bad_env_fails_fast": ["TaskError", True],
    "new_env_when_pool_is_full": "yes",
    "job_env_inherited": ["SUCCEEDED", True],
    "job_working_dir": ["SUCCEEDED", True],
    "pip_from_local_sdist": "from-venv",
    "custom_plugin": "HELLO",
    "job_level_env": "set",
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime_env")
    return tuple(run_driver(tmp, DRIVER, pkg, timeout=600)
                 for pkg in ("ray_tpu", "ray_tpu_torch"))


def _case(results, name):
    ref, out = results
    assert out[name] == ref[name]
    assert out[name] == EXPECTED[name]


@pytest.mark.parametrize("cls_path", ["ray_tpu.runtime_env",
                                      "ray_tpu_torch.runtime_env"])
def test_runtime_env_validation(cls_path):
    import importlib

    RuntimeEnv = importlib.import_module(cls_path).RuntimeEnv
    assert RuntimeEnv(pip=["requests"])["pip"] == ["requests"]
    with pytest.raises(TypeError):
        RuntimeEnv(pip=[1, 2])
    with pytest.raises(ValueError):
        RuntimeEnv(conda="env.yml")
    with pytest.raises(ValueError):
        RuntimeEnv(bogus_field=1)
    with pytest.raises(TypeError):
        RuntimeEnv(env_vars={"A": 1})


def test_env_vars_per_task(results):
    _case(results, "env_vars_per_task")


def test_working_dir_ships_code(results):
    _case(results, "working_dir")


def test_py_modules(results):
    _case(results, "py_modules")


def test_actor_runtime_env(results):
    _case(results, "actor_env")


def test_job_level_runtime_env(results):
    _case(results, "job_level_env")


def test_bad_runtime_env_fails_fast(results):
    _case(results, "bad_env_fails_fast")


def test_new_env_when_pool_is_full(results):
    _case(results, "new_env_when_pool_is_full")


def test_job_env_inherited_by_tasks(results):
    _case(results, "job_env_inherited")


def test_job_submission_working_dir(results):
    _case(results, "job_working_dir")


def test_pip_env_installs_dependency_driver_lacks(results):
    _case(results, "pip_from_local_sdist")


def test_conda_still_rejected():
    from ray_tpu_torch.runtime_env import RuntimeEnv

    with pytest.raises(ValueError, match="conda"):
        RuntimeEnv(conda={"dependencies": ["pip"]})


def test_custom_plugin_propagates_to_workers(results):
    _case(results, "custom_plugin")
