"""MovieLens-1M (paddle_tpu/data/datasets/movielens.py): samples of
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
score), the recommender_system book model's 8 feed slots, and the helpers
max_user_id, max_movie_id, max_job_id, age_table, movie_categories,
get_movie_title_dict, user_info and movie_info.

ml-1m.zip ('::'-separated users.dat, movies.dat and ratings.dat) is read
where it lies under data_home()/movielens, each rating in the test split
with probability 0.1 by random.Random(0), as the reference splits it;
otherwise the JAX loader's seeded synthetic ratings: users and movies with
6 latent factors and biases, score = clip(round(u·v + biases + 3 + noise),
1, 5).
"""

from __future__ import annotations

import functools
import os
import random
import re
import zipfile

import numpy as np

from . import data_home

age_table = [1, 18, 25, 35, 45, 50, 56]

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

_N_USERS = 400
_N_MOVIES = 300
_N_JOBS = 21
_N_CATEGORIES = 18
_TITLE_VOCAB = 1000
_N_TRAIN, _N_TEST = 6000, 600
_DIM = 6


def fetch():
    """The cached ml-1m.zip (common.download: nothing is fetched)."""
    from .common import download

    return download(URL, "movielens", MD5)


def _real_zip():
    p = os.path.join(data_home(), "movielens", "ml-1m.zip")
    return p if os.path.exists(p) else None


@functools.lru_cache(maxsize=None)
def _real_meta(zip_path):
    """movies {id: (title, categories)}, users {id: (gender, age index,
    job)}, the category and title-word dictionaries (sorted)."""
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movies, users = {}, {}
    title_words, categories = set(), set()
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode("latin-1").strip().split("::")
                cats = cats.split("|")
                categories.update(cats)
                m = pattern.match(title)
                title = (m.group(1) if m else title).strip()
                movies[int(mid)] = (title, cats)
                title_words.update(w.lower() for w in title.split())
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _ = line.decode("latin-1").strip().split("::")
                users[int(uid)] = (0 if gender == "M" else 1, age_table.index(int(age)),
                                   int(job))
    cat_dict = {c: i for i, c in enumerate(sorted(categories))}
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    return movies, users, cat_dict, title_dict


def _real_reader(zip_path, is_test, rand_seed=0, test_ratio=0.1):
    def reader():
        movies, users, cat_dict, title_dict = _real_meta(zip_path)
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(zip_path) as z, z.open("ml-1m/ratings.dat") as f:
            for line in f:
                if (rand.random() < test_ratio) != is_test:
                    continue
                uid, mid, score, _ = line.decode("latin-1").strip().split("::")
                uid, mid = int(uid), int(mid)
                gender, age_id, job = users[uid]
                title, cats = movies[mid]
                yield (uid, gender, age_id, job, mid, [cat_dict[c] for c in cats],
                       [title_dict[w.lower()] for w in title.split()], float(score))

    return reader


def max_user_id() -> int:
    z = _real_zip()
    return max(_real_meta(z)[1]) if z else _N_USERS


def max_movie_id() -> int:
    z = _real_zip()
    return max(_real_meta(z)[0]) if z else _N_MOVIES


def max_job_id() -> int:
    z = _real_zip()
    if z:
        return max(job for _, _, job in _real_meta(z)[1].values())
    return _N_JOBS - 1


def movie_categories():
    z = _real_zip()
    return dict(_real_meta(z)[2]) if z else {f"genre{i}": i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    z = _real_zip()
    return dict(_real_meta(z)[3]) if z else {f"t{i}": i for i in range(_TITLE_VOCAB)}


@functools.lru_cache(maxsize=None)
def _factors():
    rng = np.random.RandomState(2024)
    u = rng.randn(_N_USERS + 1, _DIM) * 0.8
    v = rng.randn(_N_MOVIES + 1, _DIM) * 0.8
    ub = rng.randn(_N_USERS + 1) * 0.3
    vb = rng.randn(_N_MOVIES + 1) * 0.3
    genders = rng.randint(0, 2, _N_USERS + 1)
    ages = rng.randint(0, len(age_table), _N_USERS + 1)
    jobs = rng.randint(0, _N_JOBS, _N_USERS + 1)
    cats = [sorted(rng.choice(_N_CATEGORIES, size=rng.randint(1, 4), replace=False))
            for _ in range(_N_MOVIES + 1)]
    titles = [list(rng.randint(0, _TITLE_VOCAB, size=rng.randint(2, 6)))
              for _ in range(_N_MOVIES + 1)]
    return u, v, ub, vb, genders, ages, jobs, cats, titles


def user_info():
    z = _real_zip()
    if z:
        return {uid: {"gender": g, "age": a, "job": j}
                for uid, (g, a, j) in _real_meta(z)[1].items()}
    _, _, _, _, genders, ages, jobs, _, _ = _factors()
    return {i: {"gender": int(genders[i]), "age": int(ages[i]), "job": int(jobs[i])}
            for i in range(1, _N_USERS + 1)}


def movie_info():
    z = _real_zip()
    if z:
        movies, _, cat_dict, title_dict = _real_meta(z)
        return {mid: {"categories": [cat_dict[c] for c in cats],
                      "title": [title_dict[w.lower()] for w in t.split()]}
                for mid, (t, cats) in movies.items()}
    *_, cats, titles = _factors()
    return {i: {"categories": [int(c) for c in cats[i]], "title": [int(t) for t in titles[i]]}
            for i in range(1, _N_MOVIES + 1)}


def _reader(n, seed):
    u, v, ub, vb, genders, ages, jobs, cats, titles = _factors()

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            uid = rng.randint(1, _N_USERS + 1)
            mid = rng.randint(1, _N_MOVIES + 1)
            raw = u[uid] @ v[mid] + ub[uid] + vb[mid] + 3.0 + 0.2 * rng.randn()
            yield (uid, int(genders[uid]), int(ages[uid]), int(jobs[uid]), mid,
                   [int(c) for c in cats[mid]], [int(t) for t in titles[mid]],
                   float(np.clip(np.round(raw), 1, 5)))

    return reader


def train():
    z = _real_zip()
    return _real_reader(z, is_test=False) if z else _reader(_N_TRAIN, 11)


def test():
    z = _real_zip()
    return _real_reader(z, is_test=True) if z else _reader(_N_TEST, 12)


def convert(path):
    """Recordio shards of both splits (common.convert: not ported yet)."""
    from . import common

    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
